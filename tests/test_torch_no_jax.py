"""The port imports no JAX: with jax, flax, optax and ich_tpu blocked, every
module of ich_tpu_torch and chip_smoke.py's module-level imports load, and
none of them imports pandas, PIL or scikit-learn. With those three blocked
as well, the SegICH 2D CSV path runs: the supervised2d CLI takes a
port-written tree to its aggregates on the CPU."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    for name in ("jax", "jaxlib", "flax", "optax", "ich_tpu"):
        sys.modules[name] = None  # any import of these now raises ImportError
    import ich_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(ich_tpu_torch.__path__, "ich_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "ich_tpu")
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
                 "ich_tpu_torch.postprocessing.update_pred"):
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
    for name in ("jax", "jaxlib", "flax", "optax", "ich_tpu", "pandas", "PIL", "sklearn"):
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
    for k in (1, 2):
        assert (tmp_path / "out" / "exp" / f"Fold_{k}" / "pred" /
                "volume_prediction_scores.csv").exists()
    assert (tmp_path / "out" / "exp" / "all_volume_prediction.csv").exists()
