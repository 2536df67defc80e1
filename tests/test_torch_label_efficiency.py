"""Classification pretraining, the label-efficiency sweep and the new CLIs
against the JAX package on the same inputs:

- ``pretrain_classifier`` (binary and 7-way) in both packages: the head
  ``MLP_head + (n_out,)``, the artifacts and the metric keys;
- ``label_efficiency_sweep`` with ``run_supervised_2d_with_init`` stubbed
  in both packages: the same sub-configs (the low-label recipe's
  ``frac_negative`` and stretched ``n_epoch``) and the same kept patients
  per fold and fraction;
- the CSV path of ``run_supervised_2d`` with the loader stubbed in both
  packages: the same training and test rows per fold for a label fraction
  and a negative cap (pandas and scikit-learn in the JAX package, neither
  in the port);
- a small real sweep through ``python -m ich_tpu_torch.experiments.
  label_efficiency``, and the ``binary_resnet``, ``brain_extraction`` and
  ``pretrain_finetune classifier`` CLIs, on tiny trees on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

import ich_tpu.experiments.pretrain_finetune as jax_pf
import ich_tpu.experiments.supervised2d as jax_sup
from ich_tpu.data import synthetic_ich_slices as jax_synthetic_ich_slices
from ich_tpu.data.core import LabeledSliceDataset as JaxLabeled
from ich_tpu_torch.data.core import SliceDataset2D
from ich_tpu_torch.data.datasets import write_rsna_slice_info
from ich_tpu_torch.data.synthetic import (
    synthetic_ich_slices,
    synthetic_rsna_slices,
    write_rsna_tree,
    write_segich_tree,
)
from ich_tpu_torch.experiments import (
    binary_resnet,
    brain_extraction,
    label_efficiency,
    segment_brain,
)
from ich_tpu_torch.experiments import pretrain_finetune as pf
from ich_tpu_torch.experiments import supervised2d as sup

torch.set_num_threads(2)

RECIPE = {"below": 0.15, "frac_negative": 0.25, "epoch_mult": 2}


def _cfg(tmp_path, name="le"):
    return {
        "exp_name": name, "seed": 42,
        "path": {"DATA": str(tmp_path / "segich"), "RSNA_DATA": str(tmp_path / "rsna"),
                 "OUTPUT": str(tmp_path / "out")},
        "data": {"win_center": 50, "win_width": 200, "size": 32,
                 "augmentation": {"train": {}, "eval": {}}},
        "dataset": {"frac_negative": 2},
        "split": {"n_fold": 2, "shuffle": True},
        "net": {"depth": 3, "top_filter": 4, "midchannels_factor": 1, "p_dropout": 0.0,
                "MLP_head": [16]},
        "train": {"loss_fn": "BinaryDiceLoss", "loss_fn_kwargs": {"reduction": "mean"},
                  "n_epoch": 1, "batch_size": 8, "lr": 1e-3, "validate_epoch": False},
    }


@pytest.mark.parametrize("multi", [False, True])
def test_pretrain_classifier_matches_jax(tmp_path, multi):
    n_out = 7 if multi else 2
    cfg = _cfg(tmp_path)
    port = synthetic_rsna_slices(n_slices=16, size=32, seed=2)
    jcfg = {**cfg, "path": {**cfg["path"], "OUTPUT": str(tmp_path / "jax")}}
    jweights = jax_pf.pretrain_classifier(jcfg, JaxLabeled(port.images, port.labels), multi=multi)
    weights = pf.pretrain_classifier(cfg, port, multi=multi, device="cpu")
    assert tuple(weights["mlp_head.fc_layers.1.weight"].shape) == (n_out, 16)
    assert np.asarray(jweights["params"]["mlp_head"]["fc1"]["kernel"]).shape == (16, n_out)
    pre, jpre = (os.path.join(c["path"]["OUTPUT"], "le", "pretrain_classifier")
                 for c in (cfg, jcfg))
    for name in ("pretrained.bin", "outputs.json", "classifier_scores.json", "checkpoint.bin"):
        assert os.path.exists(os.path.join(pre, name)) and os.path.exists(os.path.join(jpre, name))
    with open(os.path.join(pre, "classifier_scores.json")) as f, \
            open(os.path.join(jpre, "classifier_scores.json")) as g:
        assert json.load(f).keys() == json.load(g).keys()
    saved = torch.load(os.path.join(pre, "pretrained.bin"), weights_only=True)
    assert all(torch.equal(saved[k], v) for k, v in weights.items())
    hist = json.load(open(os.path.join(pre, "outputs.json")))["train"]["evolution"]
    assert len(hist) == 1 and np.isfinite(hist[0][1])
    moved = sup.UNet2D(sup.build_unet_from_cfg(cfg["net"]), device="cpu").transfer_weights(weights)
    assert moved and all(k.startswith(("down_block", "bottleneck_block")) for k in moved)


def _folds(make):
    return lambda k: (make(n_slices=40, size=16, n_volumes=10, seed=k),
                      make(n_slices=8, size=16, n_volumes=2, seed=50 + k))


def _stub(monkeypatch, module):
    calls = []

    def record(cfg, pretrained, datasets_by_fold, **kw):
        folds = None
        if datasets_by_fold is not None:
            folds = [sorted(set(np.asarray(datasets_by_fold(k)[0].vol_ids).tolist()))
                     for k in range(cfg["split"]["n_fold"])]
        calls.append((json.loads(json.dumps(cfg)), folds))
        return cfg["exp_name"]

    monkeypatch.setattr(module, "run_supervised_2d_with_init", record)
    return calls


@pytest.mark.parametrize("with_folds", [True, False])
def test_sweep_matches_jax(monkeypatch, tmp_path, with_folds):
    cfg = _cfg(tmp_path)
    fracs = (0.1, 0.25, 0.5, 1.0)
    jcalls, calls = _stub(monkeypatch, jax_pf), _stub(monkeypatch, pf)
    want = jax_pf.label_efficiency_sweep(
        cfg, None, _folds(jax_synthetic_ich_slices) if with_folds else None, fractions=fracs,
        seed=7, low_label_recipe=RECIPE)
    got = pf.label_efficiency_sweep(
        cfg, None, _folds(synthetic_ich_slices) if with_folds else None, fractions=fracs, seed=7,
        low_label_recipe=RECIPE, device="cpu")
    assert got == want
    assert calls == jcalls and len(calls) == 4
    assert calls[0][0]["dataset"] == {"frac_negative": 0.25, "label_fraction": 0.1}
    assert calls[0][0]["train"]["n_epoch"] == 2 and calls[1][0]["train"]["n_epoch"] == 1
    assert calls[1][0]["exp_name"] == "le_frac25"
    if with_folds:
        assert [len(c[1][0]) for c in calls] == [1, 2, 5, 10]


class _Stop(Exception):
    pass


def _csv_rows(monkeypatch, module, cfg, n_fold):
    """Per fold, the (patient, slice) rows the CSV path hands the loader
    for training and for testing; the loader stubbed to stop the fold."""
    rows = []

    def loader(data_dir, info_df, window, size):
        rows.append(list(zip(np.asarray(info_df["PatientNumber"]).tolist(),
                             np.asarray(info_df["SliceNumber"]).tolist())))
        if len(rows) % 2 == 0:
            raise _Stop
        return None

    monkeypatch.setattr(module, "load_segich_2d", loader)
    out = os.path.join(cfg["path"]["OUTPUT"], cfg["exp_name"])
    for k in range(n_fold):
        with pytest.raises(_Stop):
            module.run_supervised_2d(cfg, **({"device": "cpu"} if module is sup else {}))
        os.makedirs(os.path.join(out, f"Fold_{k + 1}"), exist_ok=True)
        with open(os.path.join(out, f"Fold_{k + 1}", "outputs.json"), "w") as f:
            f.write("{}")  # the fold counts as done: the next run takes fold k + 2
    return [(rows[2 * k], rows[2 * k + 1]) for k in range(n_fold)]


@pytest.fixture(scope="module")
def segich_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("segich"))
    ds = synthetic_ich_slices(n_slices=60, size=16, n_volumes=12, seed=3, positive_frac=0.3)
    write_segich_tree(ds, root)
    return root


@pytest.mark.parametrize("fraction,frac_negative", [(1.0, 2), (0.5, 0.25), (0.25, 1)])
def test_csv_path_keeps_the_jax_rows(monkeypatch, tmp_path, segich_tree, fraction,
                                     frac_negative):
    cfg = _cfg(tmp_path)
    cfg["path"]["DATA"] = segich_tree
    cfg["split"]["n_fold"] = 3
    cfg["dataset"] = {"frac_negative": frac_negative, "label_fraction": fraction}
    want = _csv_rows(monkeypatch, jax_sup, {**cfg, "exp_name": "jax"}, 3)
    got = _csv_rows(monkeypatch, sup, {**cfg, "exp_name": "port"}, 3)
    assert got == want
    assert all(len(tr) > 0 and len(te) > 0 for tr, te in got)


def test_label_efficiency_cli_runs_a_sweep_on_the_csv_path(tmp_path, capsys, segich_tree):
    """``python -m ich_tpu_torch.experiments.label_efficiency`` without
    pretraining, two fractions with the recipe: each fraction's aggregates,
    the fine-tune's folds trained on the kept patients."""
    cfg = _cfg(tmp_path)
    cfg["path"]["DATA"] = segich_tree
    fn = str(tmp_path / "cfg.json")
    json.dump(cfg, open(fn, "w"))
    out = label_efficiency.main([fn, "--pretrain", "none", "--fractions", "0.1,1.0",
                                 "--low-label-recipe", "--device", "cpu"])
    printed = capsys.readouterr().out
    assert sorted(out) == [0.1, 1.0]
    for frac, name in ((0.1, "le_frac10"), (1.0, "le_frac100")):
        assert out[frac] == os.path.join(cfg["path"]["OUTPUT"], name)
        assert os.path.exists(os.path.join(out[frac], "average_scores.txt"))
        assert f"fraction {frac:.0%}: Dice = " in printed
    with open(os.path.join(out[0.1], "config.json")) as f:
        saved = json.load(f)
    assert saved["train"]["n_epoch"] == 2 and saved["dataset"]["frac_negative"] == 0.25
    log = open(os.path.join(out[0.1], "Fold_1", "log.txt")).read()
    train_row = next(ln for ln in log.splitlines() if ln.startswith("Train"))
    n_train, n_neg, n_pos = (int(v) for v in train_row.split()[1:4])
    assert n_pos > 0 and n_neg <= np.ceil(0.25 * n_pos) and n_train == n_neg + n_pos


@pytest.fixture(scope="module")
def rsna_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("rsna")
    label_csv = write_rsna_tree(str(root), n_slices=16, size=40, seed=1)
    rsna = os.path.join(str(root), "stage_2_train")
    write_rsna_slice_info(label_csv, os.path.join(rsna, "slice_info.csv"))
    return rsna


def test_binary_resnet_cli(tmp_path, rsna_dir):
    cfg = _cfg(tmp_path, "resnet")
    cfg["path"]["RSNA_DATA"] = rsna_dir
    cfg["net"] = {"name": "ResNet18"}
    cfg["train"].update(n_epoch=2, class_weight=[0.5, 1.5])
    fn = str(tmp_path / "cfg.json")
    json.dump(cfg, open(fn, "w"))
    out = binary_resnet.main([fn, "--device", "cpu"])
    for name in ("resnet_classifier.bin", "classifier_scores.json", "outputs.json"):
        assert os.path.exists(os.path.join(out, name)), name
    sd = torch.load(os.path.join(out, "resnet_classifier.bin"), weights_only=True)
    assert tuple(sd["linear.weight"].shape) == (2, 512) and "layer4.1.bn2.running_var" in sd
    scores = json.load(open(os.path.join(out, "classifier_scores.json")))
    assert set(scores) == {"accuracy", "recall", "precision", "f1", "auc"}
    hist = json.load(open(os.path.join(out, "outputs.json")))["train"]["evolution"]
    assert [r[0] for r in hist] == [1, 2] and all(np.isfinite(r[1]) for r in hist)


def test_brain_extraction_cli(tmp_path):
    """k-fold on a tree whose masks are the head's interior, then the
    train-on-all model."""
    ds = synthetic_ich_slices(n_slices=24, size=32, n_volumes=4, seed=8)
    yy, xx = np.mgrid[0:32, 0:32]
    brain = ((yy - 16) ** 2 + (xx - 16) ** 2 < (0.42 * 32) ** 2).astype(np.float32)
    write_segich_tree(SliceDataset2D(ds.images, np.broadcast_to(brain, ds.masks.shape),
                                     ds.vol_ids, ds.slice_nbrs), str(tmp_path / "segich"))
    cfg = _cfg(tmp_path, "brain")
    fn = str(tmp_path / "cfg.json")
    json.dump(cfg, open(fn, "w"))
    out = brain_extraction.main([fn, "--device", "cpu"])
    for name in ("average_scores.txt", "Fold_2/trained_unet.bin", "final_brain_unet.bin"):
        assert os.path.exists(os.path.join(out, name)), name
    assert not os.path.exists(os.path.join(out, "final_checkpoint.bin.tmp"))
    sd = torch.load(os.path.join(out, "final_brain_unet.bin"), weights_only=True)
    assert set(sd) == set(sup.build_unet_from_cfg(cfg["net"]).state_dict())


def test_pretrain_finetune_classifier_cli(monkeypatch, tmp_path, rsna_dir):
    """``pretrain_finetune classifier --multi``: 7-way pretraining on the
    RSNA slices, its weights handed to the fine-tune."""
    calls = _stub(monkeypatch, pf)
    cfg = _cfg(tmp_path, "cls")
    cfg["path"]["RSNA_DATA"] = rsna_dir
    fn = str(tmp_path / "cfg.json")
    json.dump(cfg, open(fn, "w"))
    pf.main(["classifier", fn, "--multi", "--device", "cpu"])
    assert len(calls) == 1 and calls[0][1] is None
    assert os.path.exists(tmp_path / "out" / "cls" / "pretrain_classifier" / "pretrained.bin")
    sd = torch.load(tmp_path / "out" / "cls" / "pretrain_classifier" / "pretrained.bin",
                    weights_only=True)
    assert tuple(sd["mlp_head.fc_layers.1.weight"].shape) == (7, 16)


def test_new_entry_points_raise_for_cuda_without_a_card(tmp_path, rsna_dir, segich_tree):
    """No fallback to the CPU: each new CLI asked for ``cuda`` on a machine
    without a card raises before it trains."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = _cfg(tmp_path, "nocard")
    cfg["path"].update(RSNA_DATA=rsna_dir, DATA=segich_tree)
    fn = str(tmp_path / "cfg.json")
    json.dump(cfg, open(fn, "w"))
    resnet = str(tmp_path / "resnet.json")
    json.dump({**cfg, "net": {"name": "ResNet18"}}, open(resnet, "w"))
    runs = [lambda: label_efficiency.main([fn, "--pretrain", "none", "--fractions", "1.0"]),
            lambda: binary_resnet.main([resnet]),
            lambda: brain_extraction.main([fn]),
            lambda: pf.main(["classifier", fn]),
            lambda: segment_brain.main(["v.nii", "-o", str(tmp_path), "-m", "m.bin"])]
    for run in runs:
        with pytest.raises(RuntimeError, match="cuda"):
            run()
    assert not os.path.exists(tmp_path / "out" / "nocard" / "Fold_1" / "outputs.json")
