"""The port imports no JAX: with jax, flax, optax, ich_tpu, matplotlib and
imageio blocked, every module of ich_tpu_torch and chip_smoke.py's
module-level imports load, and none of them imports pandas, PIL or
scikit-learn. With those three blocked as well, the SegICH 2D CSV path
runs: the supervised2d CLI takes a port-written tree to its aggregates on
the CPU, and without matplotlib logs that it skipped the analysis PDF; the
data preparation CLI writes a SegICH 2D tree from NIfTIs and extracts a
CQ500 root with click blocked too; and the SN-PatchGAN CLI
trains a tiny generator on a port-written RSNA tree, whose weights the
inpainting-AD CLI then runs (with a ResNet-18 gate) on a SegICH tree, its
attention export included; the AE CLI trains and detects, the FCDD CLI
trains and evaluates volumes, and the attention U-Net CLI runs on a tree
merged from an attention export."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    for name in ("jax", "jaxlib", "flax", "optax", "ich_tpu", "matplotlib", "imageio"):
        sys.modules[name] = None  # any import of these now raises ImportError
    import ich_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(ich_tpu_torch.__path__, "ich_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    loaded = [m for m in sys.modules if m.split(".")[0] in
              ("jax", "flax", "optax", "ich_tpu", "matplotlib", "imageio")
              and sys.modules[m] is not None]
    assert not loaded, loaded
    for name in ("ich_tpu_torch.ops.transforms3d", "ich_tpu_torch.data.patch_sampler",
                 "ich_tpu_torch.experiments.supervised3d", "ich_tpu_torch.train.ssl",
                 "ich_tpu_torch.experiments.pretrain_finetune", "ich_tpu_torch.train.classifier",
                 "ich_tpu_torch.models.resnet", "ich_tpu_torch.experiments.label_efficiency",
                 "ich_tpu_torch.experiments.binary_resnet",
                 "ich_tpu_torch.experiments.brain_extraction",
                 "ich_tpu_torch.experiments.pred_on_brain",
                 "ich_tpu_torch.experiments.segment_brain",
                 "ich_tpu_torch.postprocessing.update_pred",
                 "ich_tpu_torch.ops.masks", "ich_tpu_torch.ops.morphology",
                 "ich_tpu_torch.models.inpainting", "ich_tpu_torch.train.gan",
                 "ich_tpu_torch.train.inpaint_ad", "ich_tpu_torch.data.png",
                 "ich_tpu_torch.experiments.inpainting_gan",
                 "ich_tpu_torch.experiments.ad_inpainting", "ich_tpu_torch.models.ae",
                 "ich_tpu_torch.models.fcdd", "ich_tpu_torch.train.ae_trainer",
                 "ich_tpu_torch.train.fcdd_trainer", "ich_tpu_torch.experiments.ae_ad",
                 "ich_tpu_torch.experiments.fcdd",
                 "ich_tpu_torch.experiments.attention_unet2d",
                 "ich_tpu_torch.parallel.mesh", "ich_tpu_torch.parallel.sharded_inference",
                 "ich_tpu_torch.train.checkpoint_sharded",
                 "ich_tpu_torch.experiments.data_preparation",
                 "ich_tpu_torch.experiments.figures", "ich_tpu_torch.native",
                 "ich_tpu_torch.postprocessing.plots",
                 "ich_tpu_torch.postprocessing.analyse_exp",
                 "ich_tpu_torch.experiments.label_efficiency_study",
                 "ich_tpu_torch.utils.profiling", "ich_tpu_torch.utils.rng",
                 "ich_tpu_torch.models.init"):
        assert name in names, name
    # sklearn is imported only inside evaluate_representation
    assert not {"sklearn", "pandas", "PIL"} & set(sys.modules), sys.modules.keys()
    print(len(names))
""")


def test_port_and_chip_smoke_import_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 40  # every submodule of the slices was imported


CSV_PROBE = textwrap.dedent("""
    import json, os, sys
    for name in ("jax", "jaxlib", "flax", "optax", "ich_tpu", "pandas", "PIL", "sklearn",
                 "matplotlib", "imageio"):
        sys.modules[name] = None  # any import of these now raises ImportError
    from ich_tpu_torch.data.synthetic import synthetic_ich_slices, write_segich_tree
    from ich_tpu_torch.experiments import supervised2d
    work = sys.argv[1]
    write_segich_tree(synthetic_ich_slices(n_slices=24, size=40, n_volumes=6, seed=5),
                      os.path.join(work, "data"))
    with open("configs/unet2d.json") as f:
        cfg = json.load(f)
    cfg["exp_name"] = "exp"
    cfg["path"] = {"DATA": os.path.join(work, "data"), "OUTPUT": os.path.join(work, "out")}
    cfg["split"]["n_fold"] = 2
    cfg["data"]["size"] = 32
    cfg["net"].update(depth=3, top_filter=4)
    cfg["train"].update(n_epoch=1, batch_size=8)
    with open(os.path.join(work, "cfg.json"), "w") as f:
        json.dump(cfg, f)
    out = supervised2d.main([os.path.join(work, "cfg.json"), "--device", "cpu"])
    loaded = [m for m in sys.modules if sys.modules[m] is not None and m.split(".")[0] in
              ("jax", "ich_tpu", "pandas", "PIL", "sklearn")]
    assert not loaded, loaded
    print(open(os.path.join(out, "average_scores.txt")).read().splitlines()[0])
""")


def test_segich_csv_path_runs_without_pandas_pil_or_sklearn(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", CSV_PROBE, str(tmp_path)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.splitlines()[-1].startswith("Dice = ")
    assert "analysis PDF skipped: import of matplotlib halted" in r.stdout
    assert not (tmp_path / "out" / "exp" / "results_overview.pdf").exists()
    for k in (1, 2):
        assert (tmp_path / "out" / "exp" / f"Fold_{k}" / "pred" /
                "volume_prediction_scores.csv").exists()
    assert (tmp_path / "out" / "exp" / "all_volume_prediction.csv").exists()


PREP_PROBE = textwrap.dedent("""
    import os, sys
    for name in ("jax", "jaxlib", "flax", "optax", "ich_tpu", "pandas", "PIL", "sklearn",
                 "click", "matplotlib", "imageio"):
        sys.modules[name] = None  # any import of these now raises ImportError
    import numpy as np
    from ich_tpu_torch.data import nifti
    from ich_tpu_torch.data.synthetic import synthetic_ich_volume, write_cq500_tree
    from ich_tpu_torch.experiments import data_preparation
    work = sys.argv[1]
    for sub in ("ct_scans", "masks"):
        os.makedirs(os.path.join(work, "nifti", sub))
    for pid in (1, 2):
        vol, mask = synthetic_ich_volume(size=32, depth=6, seed=pid)
        nifti.save(os.path.join(work, "nifti", "ct_scans", f"{pid:03}.nii"), vol)
        nifti.save(os.path.join(work, "nifti", "masks", f"{pid:03}.nii"), mask.astype(np.uint8))
    with open(os.path.join(work, "demo.csv"), "w") as f:
        f.write("Patient Number,Age,Gender\\n,,\\n2,50,Male\\nTotal,,\\n,,\\n")
    data_preparation.main(["gen-2d-seg", "--data-dir", os.path.join(work, "nifti"),
                           "--out-dir", os.path.join(work, "seg2d"),
                           "--demographics-csv", os.path.join(work, "demo.csv")])
    write_cq500_tree(os.path.join(work, "cq500"), n_patients=2, n_slices=4, size=16)
    data_preparation.main(["qure-extract", "--input-path", os.path.join(work, "cq500"),
                           "--out-folder", os.path.join(work, "qure")])
    loaded = [m for m in sys.modules if sys.modules[m] is not None and m.split(".")[0] in
              ("jax", "ich_tpu", "pandas", "PIL", "sklearn", "click", "matplotlib", "imageio")]
    assert not loaded, loaded
""")


def test_data_preparation_runs_without_pandas_pil_or_click(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", PREP_PROBE, str(tmp_path)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(tmp_path / "seg2d" / "patient_info.csv") as f:
        assert f.read() == ",PatientNumber,Hemorrhage,Age,Gender\n0,1,1,,\n1,2,1,50.0,Male\n"
    assert len(os.listdir(tmp_path / "seg2d" / "1" / "ct")) == 6
    assert sorted(os.listdir(tmp_path / "qure")) == ["0.nii", "1.nii", "info.csv"]


GAN_AD_PROBE = textwrap.dedent("""
    import json, os, sys
    for name in ("jax", "jaxlib", "flax", "optax", "ich_tpu", "pandas", "PIL", "sklearn"):
        sys.modules[name] = None  # any import of these now raises ImportError
    import torch
    from ich_tpu_torch.data.datasets import write_rsna_slice_info
    from ich_tpu_torch.data.synthetic import synthetic_ich_slices, write_rsna_tree, write_segich_tree
    from ich_tpu_torch.experiments import ad_inpainting, inpainting_gan
    from ich_tpu_torch.models.resnet import resnet18
    from ich_tpu_torch.train.checkpoint import save_params
    work = sys.argv[1]
    rsna = os.path.join(work, "rsna", "stage_2_train")
    label_csv = write_rsna_tree(os.path.join(work, "rsna"), n_slices=16, size=48, seed=3)
    write_rsna_slice_info(label_csv, os.path.join(rsna, "slice_info.csv"))
    with open("configs/inpainting_gan.json") as f:
        cfg = json.load(f)
    cfg["path"] = {"RSNA_DATA": rsna, "OUTPUT": os.path.join(work, "out")}
    cfg["data"]["size"] = 32
    cfg["net"].update(lat_channels=4, disc_channels=[8, 16, 16])
    cfg["mask"].update(brush_width=[3, 6], length=[3, 8])
    cfg["train"].update(n_epoch=5, batch_size=4, checkpoint_freq=1)  # validation at epoch 5
    with open(os.path.join(work, "gan.json"), "w") as f:
        json.dump(cfg, f)
    gan_dir = inpainting_gan.main([os.path.join(work, "gan.json"), "--device", "cpu"])

    write_segich_tree(synthetic_ich_slices(n_slices=4, size=40, n_volumes=2, seed=5),
                      os.path.join(work, "segich"))
    torch.manual_seed(0)
    save_params(os.path.join(work, "gate.bin"), resnet18(num_classes=2).state_dict())
    cfg["exp_name"] = "ad"
    cfg["path"] = {"DATA": os.path.join(work, "segich"), "OUTPUT": os.path.join(work, "out")}
    cfg["ad"] = {"generator_path": os.path.join(gan_dir, "snpatchgan.bin"),
                 "classifier_path": os.path.join(work, "gate.bin"), "gate_threshold": 0.0,
                 "grid_hole": [8, 8], "grid_step": 8, "batch_size": 4, "n_iter": 1,
                 "angles": [7.5]}
    with open(os.path.join(work, "ad.json"), "w") as f:
        json.dump(cfg, f)
    ad_inpainting.main([os.path.join(work, "ad.json"), "--device", "cpu",
                        "--export-attention", os.path.join(work, "att")])
    loaded = [m for m in sys.modules if sys.modules[m] is not None and m.split(".")[0] in
              ("jax", "ich_tpu", "pandas", "PIL", "sklearn")]
    assert not loaded, loaded
    print(gan_dir)
""")


def test_gan_and_ad_clis_run_without_jax_pandas_pil_or_sklearn(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", GAN_AD_PROBE, str(tmp_path)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    gan_dir = r.stdout.splitlines()[-1]
    for name in ("checkpoint.bin", "snpatchgan.bin", "outputs.json", "valid/valid_ep5_0.png"):
        assert os.path.exists(os.path.join(gan_dir, name)), name
    ad_dir = tmp_path / "out" / "ad"
    for name in ("slice_prediction_scores.csv", "volume_prediction_scores.csv"):
        assert (ad_dir / name).exists(), name
    with open(tmp_path / "att" / "info.csv") as f:
        rows = f.read().splitlines()
    assert rows[0] == ",PatientNumber,SliceNumber,attention_fn" and len(rows) == 5
    assert rows[1].split(",")[0] == "0" and rows[1].endswith("_attention.png")
    assert all((tmp_path / "att" / r.split(",")[3]).exists() for r in rows[1:])


AD_SUITE_PROBE = textwrap.dedent("""
    import csv, json, os, sys
    for name in ("jax", "jaxlib", "flax", "optax", "ich_tpu", "pandas", "PIL", "sklearn"):
        sys.modules[name] = None  # any import of these now raises ImportError
    import numpy as np
    from ich_tpu_torch.data.datasets import write_rsna_slice_info
    from ich_tpu_torch.data.segich import load_segich_2d
    from ich_tpu_torch.data.synthetic import synthetic_ich_slices, write_rsna_tree, write_segich_tree
    from ich_tpu_torch.experiments import ae_ad, attention_unet2d, fcdd
    from ich_tpu_torch.experiments.ad_inpainting import save_attention_map, write_attention_info
    work = sys.argv[1]
    rsna = os.path.join(work, "rsna", "stage_2_train")
    label_csv = write_rsna_tree(os.path.join(work, "rsna"), n_slices=16, size=48, seed=3)
    write_rsna_slice_info(label_csv, os.path.join(rsna, "slice_info.csv"))
    seg = os.path.join(work, "segich")
    write_segich_tree(synthetic_ich_slices(n_slices=12, size=40, n_volumes=4, seed=5), seg)
    paths = {"RSNA_DATA": rsna, "DATA": seg, "OUTPUT": os.path.join(work, "out")}

    def run(mod, cfg, *flags):
        fn = os.path.join(work, cfg["exp_name"] + ".json")
        with open(fn, "w") as f:
            json.dump(cfg, f)
        return mod.main([fn, "--device", "cpu", *flags])

    ae = {"exp_name": "ae", "path": paths, "data": {"win_center": 50, "win_width": 200,
          "size": 32}, "net": {"latent_channels": 4, "bottelneck_channels": 4, "n_conv": 2},
          "train": {"n_epoch": 5, "batch_size": 4, "lr": 1e-3,
                    "lambda_GDL": {"0": 0.0, "1": 1.0}}}
    ae_dir = run(ae_ad, ae)
    ae["ad"] = {"model_path": os.path.join(ae_dir, "ae.bin")}
    run(ae_ad, ae, "--detect")

    with open("configs/fcdd.json") as f:
        fc = json.load(f)
    fc["path"] = paths
    fc["data"]["size"] = 32
    fc["train"].update(n_epoch=1, batch_size=4)
    fc_dir = run(fcdd, fc)
    fc["ad"]["model_path"] = os.path.join(fc_dir, "fcdd.bin")
    run(fcdd, fc, "--eval-volumes")

    test = load_segich_2d(seg, size=40)
    export = os.path.join(seg, "attention")
    write_attention_info(export, [(int(v), int(s), save_attention_map(export, int(v), int(s), m))
                                  for v, s, m in zip(test.vol_ids, test.slice_nbrs, test.images)])
    with open(os.path.join(export, "info.csv"), newline="") as f:
        att = {(r[1], r[2]): "attention/" + r[3] for r in list(csv.reader(f))[1:]}
    with open(os.path.join(seg, "ct_info.csv"), newline="") as f:
        rows = list(csv.reader(f))
    with open(os.path.join(seg, "info.csv"), "w", newline="") as f:
        csv.writer(f).writerows([rows[0] + ["attention_fn"]]
                                + [r + [att[(r[1], r[2])]] for r in rows[1:]])
    with open("configs/unet2d.json") as f:
        un = json.load(f)
    un["exp_name"] = "att"
    un["path"] = paths
    un["data"]["size"] = 32
    un["split"]["n_fold"] = 2
    un["net"].update(depth=3, top_filter=4)
    un["train"].update(n_epoch=1, batch_size=4)
    att_dir = run(attention_unet2d, un)
    loaded = [m for m in sys.modules if sys.modules[m] is not None and m.split(".")[0] in
              ("jax", "ich_tpu", "pandas", "PIL", "sklearn")]
    assert not loaded, loaded
    print(ae_dir, fc_dir, att_dir)
""")


def test_ae_fcdd_and_attention_clis_run_without_jax_pandas_pil_or_sklearn(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", AD_SUITE_PROBE, str(tmp_path)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ae_dir, fc_dir, att_dir = r.stdout.splitlines()[-1].split()
    for name in ("checkpoint.bin", "ae.bin", "outputs.json", "valid/rec_ep5_0.png",
                 "slice_prediction_scores.csv", "volume_prediction_scores.csv"):
        assert os.path.exists(os.path.join(ae_dir, name)), name
    for name in ("fcdd.bin", "outputs.json", "localization/anomaly_0.png",
                 "slice_prediction_scores.csv", "volume_prediction_scores.csv"):
        assert os.path.exists(os.path.join(fc_dir, name)), name
    with open(os.path.join(ae_dir, "slice_prediction_scores.csv")) as f:
        header = f.readline().strip().split(",")
    assert header[-1] == "pixel_AUC"
    for name in ("average_scores.txt", "all_volume_prediction.csv", "Fold_2/trained_unet.bin"):
        assert os.path.exists(os.path.join(att_dir, name)), name
