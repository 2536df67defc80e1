"""The port's pretrain -> fine-tune drivers at the JAX package's test sizes
(``tests/test_pretrain_finetune.py``: depth 3, top_filter 4, 32^2 slices):
each phase's artifacts, the fine-tune's log of the weight keys it moved,
the number of keys the local-phase weights move into the fine-tune U-Net
against the JAX package's count for the same config, and the CLI on an
RSNA tree and a SegICH tree on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ich_tpu.data.synthetic import write_segich_tree
from ich_tpu.models import PartialUNet as JaxPartialUNet
from ich_tpu.models import UNet as JaxUNet
from ich_tpu.train.segmentation2d import UNet2D as JaxUNet2D
from ich_tpu_torch.data.datasets import write_rsna_slice_info
from ich_tpu_torch.data.synthetic import synthetic_ich_slices, write_rsna_tree
from ich_tpu_torch.experiments import pretrain_finetune as pf
from ich_tpu_torch.experiments.supervised2d import build_unet_from_cfg
from ich_tpu_torch.ops import transforms as T
from ich_tpu_torch.train.segmentation2d import UNet2D

torch.set_num_threads(2)


def _cfg(tmp_path, name):
    return {
        "exp_name": name,
        "path": {"DATA": str(tmp_path / "d"), "RSNA_DATA": str(tmp_path / "r"),
                 "OUTPUT": str(tmp_path / "o")},
        "seed": 0,
        "data": {"win_center": 50, "win_width": 200, "size": 32,
                 "augmentation": {"train": {}, "eval": {}}},
        "dataset": {"frac_negative": 2},
        "split": {"n_fold": 2, "shuffle": True},
        "net": {"depth": 3, "top_filter": 4, "midchannels_factor": 1, "p_dropout": 0.0},
        "corruption": {"n_swap": 3, "swap_w": [4, 8], "swap_h": [4, 8], "rotate": True},
        "train": {"loss_fn": "BinaryDiceLoss",
                  "loss_fn_kwargs": {"reduction": "mean", "p": 2, "alpha": 0.2},
                  "n_epoch": 2, "batch_size": 8, "lr": 1e-3, "validate_epoch": False},
    }


def _folds(k):
    return (synthetic_ich_slices(16, 32, 2, seed=k), synthetic_ich_slices(16, 32, 2, seed=40 + k))


def _moved_in_log(out):
    log = open(os.path.join(out, "Fold_1", "log.txt")).read()
    line = next(ln for ln in log.splitlines() if "matching weight keys" in ln)
    return int(line.split("|")[-1].split()[0])


def test_context_restoration_to_finetune(tmp_path):
    cfg = _cfg(tmp_path, "cr")
    weights = pf.pretrain_context_restoration(cfg, synthetic_ich_slices(16, 32, 2, seed=9),
                                              device="cpu")
    pre = tmp_path / "o" / "cr" / "pretrain"
    for name in ("pretrained.bin", "outputs.json", "checkpoint.bin"):
        assert (pre / name).exists(), name
    hist = json.loads((pre / "outputs.json").read_text())["train"]["evolution"]
    assert [row[0] for row in hist] == [1, 2] and hist[1][1] < hist[0][1]  # MSE falls
    saved = torch.load(pre / "pretrained.bin", weights_only=True)
    assert all(torch.equal(saved[k], v) for k, v in weights.items())
    out = pf.run_supervised_2d_with_init(cfg, weights, _folds, device="cpu")
    assert os.path.exists(os.path.join(out, "average_scores.txt"))
    # every key of the restoration U-Net moves into the fine-tune U-Net
    assert _moved_in_log(out) == len(weights)


def test_contrastive_global_local_to_finetune(tmp_path):
    """Global then local with distinct view pipelines; the local weights
    carry the encoder and the first decoder stage into the fine-tune, as
    many keys as the JAX package moves (the port's ``num_batches_tracked``
    buffers aside, which flax has not)."""
    cfg = _cfg(tmp_path, "con")
    cfg["net"]["MLP_head"] = [16, 8]
    cfg["local"] = {"n_decoder": 1, "head_channel": [8, 4], "K": 2, "n_region": 4,
                    "n_epoch": 1, "freeze": True}
    data = synthetic_ich_slices(16, 32, 2, seed=3)
    weights = pf.pretrain_contrastive(
        cfg, data, aug_pipeline=T.Compose(T.RandomCropResize((0.4, 0.8)), T.HFlip(0.5)),
        local_aug_pipeline=T.Compose(T.RandomCropResize((0.7, 1.0))), device="cpu")
    for phase in ("pretrain_global", "pretrain_local"):
        for name in ("pretrained.bin", "outputs.json"):
            assert (tmp_path / "o" / "con" / phase / name).exists(), (phase, name)
    assert any(k.startswith("down_block") for k in weights)
    assert any(k.startswith("up_block") for k in weights)
    glob = torch.load(tmp_path / "o" / "con" / "pretrain_global" / "pretrained.bin",
                      weights_only=True)
    assert torch.equal(weights["down_block.0.conv1.weight"], glob["down_block.0.conv1.weight"])
    assert not torch.equal(weights["down_block.0.bn1.running_mean"],
                           glob["down_block.0.bn1.running_mean"])

    out = pf.run_supervised_2d_with_init(cfg, weights, _folds, device="cpu")
    moved = UNet2D(build_unet_from_cfg(cfg["net"]), device="cpu").transfer_weights(weights)
    assert _moved_in_log(out) == len(moved)
    assert any(k.startswith("up_block.0") for k in moved)
    assert not any(k.startswith("up_block.1") for k in moved)

    part = JaxPartialUNet(depth=3, n_decoder=1, top_filter=4, midchannels_factor=1,
                          head_channel=(8, 4), p_dropout=0.0)
    jweights = jax.tree_util.tree_map(np.asarray, part.init(jax.random.PRNGKey(0),
                                                            jnp.zeros((1, 32, 32, 1))))
    jt = JaxUNet2D(JaxUNet(depth=3, top_filter=4, midchannels_factor=1, p_dropout=0.0))
    jt._ensure_state((32, 32), 1)
    jmoved = jt.transfer_weights(jweights)
    assert len([k for k in moved if not k.endswith("num_batches_tracked")]) == len(jmoved)


def test_cli_context_restoration_on_rsna_and_segich_trees(tmp_path):
    """``python -m ich_tpu_torch.experiments.pretrain_finetune
    context_restoration CONFIG.json --device cpu``: the RSNA slices through
    the port's pivot and loader, pretraining, then the k-fold fine-tune on
    a SegICH tree read through its CSVs."""
    cfg = _cfg(tmp_path, "cli")
    cfg["train"]["n_epoch"] = 1
    label_csv = write_rsna_tree(str(tmp_path / "rsna"), n_slices=16, size=40, seed=1)
    rsna = str(tmp_path / "rsna" / "stage_2_train")
    write_rsna_slice_info(label_csv, os.path.join(rsna, "slice_info.csv"))
    write_segich_tree(synthetic_ich_slices(n_slices=24, size=40, n_volumes=4, seed=5),
                      str(tmp_path / "segich"))
    cfg["path"].update(RSNA_DATA=rsna, DATA=str(tmp_path / "segich"))
    fn = str(tmp_path / "cfg.json")
    with open(fn, "w") as f:
        json.dump(cfg, f)
    out = pf.main(["context_restoration", fn, "--device", "cpu"])
    assert out == str(tmp_path / "o" / "cli")
    for name in ("average_scores.txt", "all_volume_prediction.csv", "config.json",
                 "pretrain/pretrained.bin", "pretrain/outputs.json", "Fold_2/trained_unet.bin"):
        assert os.path.exists(os.path.join(out, name)), name
    assert _moved_in_log(out) > 0
    with pytest.raises(SystemExit):
        pf.main(["inpainting", fn])
