"""The port's multi-rank layer (``ich_tpu_torch.parallel``, synced
BatchNorm, the InfoNCE gather, the data-parallel trainers, the directory
checkpoint and the agreed preemption flag) on gloo ranks on the CPU.

One module fixture spawns a group of jax-free ranks
(``tests/_torch_parallel_worker.py``) at world 4, then 2, then 1, each
rank a process that joins through a file store under ``tmp_path`` (so no
two test processes share a port) and writes what it computed; each group
has a wall limit, after which it is killed and the fixture fails. The
tests then hold the results:

- against the JAX package on its virtual CPU mesh of the same device
  count: the halo-exchange inference, ``volume_parallel_map``, the InfoNCE
  gather's loss and gradient, synced BatchNorm against flax's on the global
  batch, and ``UNet2D(mesh=)`` training from carried weights;
- world N against world 1: ``UNet3D``, ``ContextRestoration``,
  ``Contrastive`` (global, local, and local with a frozen transfer), and
  ``UNet2D`` at dropout 0.5, whose masks are the global batch's rows
  (against the JAX package's mesh too);
- the checkpoint and preemption contracts at every world size.
"""

import os
import subprocess
import sys
from datetime import timedelta

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_parallel_worker as W
from ich_tpu.data import synthetic_ich_slices as jax_synthetic_ich_slices
from ich_tpu.models import UNet as JaxUNet
from ich_tpu.ops.losses import info_nce_loss as jax_info_nce_loss
from ich_tpu.parallel import sharded_inference as jsi
from ich_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ich_tpu.train.segmentation2d import UNet2D as JaxUNet2D
from ich_tpu_torch import parallel
from ich_tpu_torch.interop.from_jax import unet_state_dict_from_jax

WORKER = os.path.abspath(W.__file__)
WORLDS = (1, 2, 4)
WALL_S = 240  # one spawned group's limit


def _jax_mesh(world):
    return jax_make_mesh(jax.devices()[:world])


def _jax_conv(variables, x):
    y = jax.lax.conv_general_dilated(x, variables["kernel"], (1, 1, 1), "SAME",
                                     dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    return jax.nn.sigmoid(y + variables["bias"])


def _inputs():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    n, d_in, d_out = (W.NCE_SHAPES[k] for k in ("n", "d_in", "d_out"))
    return {
        "sw_kernel": f32(3, 3, 3, 1, 2) * 0.3, "sw_bias": f32(2) * 0.1,
        "sw_vol": rng.uniform(size=W.SW_VOL).astype(np.float32),
        "vpm_vols": rng.uniform(size=(5,) + W.VPM_VOL).astype(np.float32),
        "nce_x1": f32(n, d_in), "nce_x2": f32(n, d_in), "nce_w": f32(d_in, d_out),
        "bn_x": f32(*W.BN_SHAPE) * 2 + 1, "bn_r": f32(*W.BN_SHAPE),
        "bn_scale": rng.uniform(0.5, 1.5, W.BN_SHAPE[1]).astype(np.float32),
        "bn_bias": f32(W.BN_SHAPE[1]), "bn_mean": f32(W.BN_SHAPE[1]) * 0.1,
        "bn_var": rng.uniform(0.5, 1.5, W.BN_SHAPE[1]).astype(np.float32),
    }


def _jax_unet2d(norm, world=None, p_dropout=0.0):
    """The JAX trainer of ``case_unet2d`` (a mesh of ``world`` devices),
    its state built from seed 0."""
    jt = JaxUNet2D(JaxUNet(p_dropout=p_dropout, norm=norm, **W.UNET2D_NET),
                   mesh=None if world is None else _jax_mesh(world), **W.UNET2D_TRAIN)
    jt._ensure_state((W.UNET2D_DATA["size"],) * 2, 1)
    return jt


def _spawn(world, in_dir, out_dir):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    store = os.path.join(out_dir, f"store_w{world}")
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(world), store, in_dir,
                               out_dir], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=WALL_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"the world-{world} group passed its {WALL_S} s limit")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of world {world} failed:\n{log[-6000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]} and the inputs."""
    in_dir = str(tmp_path_factory.mktemp("parallel_in"))
    out_dir = str(tmp_path_factory.mktemp("parallel_out"))
    inputs = _inputs()
    np.savez(os.path.join(in_dir, "inputs.npz"), **inputs)
    for norm in ("batch", "group"):
        v = jax.tree_util.tree_map(np.array, _jax_unet2d(norm)._variables())
        torch.save({k: torch.from_numpy(np.array(a)) for k, a in unet_state_dict_from_jax(v).items()},
                   os.path.join(in_dir, f"unet2d_{norm}.pt"))
    for world in (4, 2, 1):  # world 4 writes the checkpoint that 2 and 1 restore
        _spawn(world, in_dir, out_dir)
    res = {w: [dict(np.load(os.path.join(out_dir, f"w{w}_r{r}.npz"))) for r in range(w)]
           for w in WORLDS}
    return res, inputs


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_agree(runs, world):
    """Every rank ends with the same results (gathered outputs, averaged
    gradients, trained weights, histories); only rank 1 saw the SIGTERM."""
    res = runs[0][world]
    for r in range(1, world):
        assert res[r].keys() == res[0].keys()
        for k, v in res[0].items():
            if k == "preempt/requested":
                assert bool(v) is False and bool(res[r][k]) is (r == 1), (r, k)
            else:
                np.testing.assert_array_equal(res[r][k], v, err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_sliding_window_matches_jax(runs, world):
    """The halo-exchange blend against the JAX package's at the same device
    count (overlap 0.5 and 0, a conv net carried by ``from_jax``), and an
    identity net against the input."""
    res, inp = runs[0][world][0], runs[1]
    variables = {"kernel": jnp.asarray(inp["sw_kernel"]), "bias": jnp.asarray(inp["sw_bias"])}
    for name, overlap in (("conv", 0.5), ("conv0", 0.0)):
        want = jsi.sliding_window_inference_sharded(
            _jax_conv, variables, jnp.asarray(inp["sw_vol"]), _jax_mesh(world),
            patch_size=W.SW_PATCH, overlap=overlap, batch_size=4)
        np.testing.assert_allclose(res[f"sw/{name}"], np.asarray(want), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    for name in ("identity", "identity0"):
        np.testing.assert_allclose(res[f"sw/{name}"][..., 0], inp["sw_vol"], atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_volume_parallel_map_matches_jax(runs, world):
    """``world + 1`` volumes (a tail round padded by repeating the last)
    against the JAX package's volume-parallel sliding window, the order of
    the results, and no volumes yielding nothing."""
    res, inp = runs[0][world][0], runs[1]
    vols = inp["vpm_vols"][:world + 1]
    variables = {"kernel": jnp.asarray(inp["sw_kernel"]), "bias": jnp.asarray(inp["sw_bias"])}
    want = jsi.sliding_window_inference_volume_parallel(
        _jax_conv, variables, jnp.asarray(vols), _jax_mesh(world), patch_size=W.SW_PATCH,
        overlap=0.5, batch_size=4)
    assert res["vpm/sw"].shape == np.asarray(want).shape
    np.testing.assert_allclose(res["vpm/sw"], np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(res["vpm/double"], vols * 2 + 1)
    assert int(res["vpm/empty"]) == 0


@pytest.mark.parametrize("world", WORLDS)
def test_info_nce_gather_matches_jax(runs, world):
    """The loss and the averaged gradient of ``z = x @ w`` through the
    gathered InfoNCE against JAX's ``info_nce_loss(axis_name=)`` under
    shard_map and against the global batch's gradient: the gather's
    backward and the gradient mean give the global gradient, not a
    multiple of it."""
    res, inp = runs[0][world][0], runs[1]
    x1, x2, w = (jnp.asarray(inp[k]) for k in ("nce_x1", "nce_x2", "nce_w"))

    def local(w, a, b):
        return jax_info_nce_loss(a @ w, b @ w, tau=0.5, axis_name="data")

    sharded = jax.shard_map(local, mesh=_jax_mesh(world), in_specs=(P(), P("data"), P("data")),
                            out_specs=P(), check_vma=False)
    loss = sharded(w, x1, x2)
    g_global = jax.grad(lambda w: jax_info_nce_loss(x1 @ w, x2 @ w, tau=0.5))(w)
    np.testing.assert_allclose(res["nce/loss"], np.asarray(loss), rtol=1e-5)
    np.testing.assert_allclose(res["nce/grad"], np.asarray(g_global), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("world", WORLDS)
def test_synced_batch_norm_matches_flax(runs, world):
    """Synced BatchNorm against flax's BatchNorm on the global batch: the
    output, the input gradient of ``sum(y * r)`` and the running statistics
    (flax's momentum 0.9 with the global count's biased variance)."""
    res, inp = runs[0][world][0], runs[1]
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": inp["bn_scale"], "bias": inp["bn_bias"]},
                 "batch_stats": {"mean": inp["bn_mean"], "var": inp["bn_var"]}}

    def f(x):
        y, upd = bn.apply(variables, x, mutable=["batch_stats"])
        return jnp.sum(y * nhwc(inp["bn_r"])), (y, upd)

    (_, (y, upd)), dx = jax.value_and_grad(f, has_aux=True)(nhwc(inp["bn_x"]))
    to_nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    np.testing.assert_allclose(res["bn/y"], to_nchw(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res["bn/dx"], to_nchw(dx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(res["bn/mean"], upd["batch_stats"]["mean"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(res["bn/var"], upd["batch_stats"]["var"], rtol=1e-5)


def adam_step1_share(a: dict, b: dict, lr: float, keys) -> float:
    """The share of the weights under ``keys`` that two runs moved to within
    lr/10 of each other in their first Adam step; every weight must be
    within 2 lr (Adam's first update is at most lr in magnitude)."""
    close = total = 0
    for k in keys:
        d = np.abs(np.asarray(a[k], np.float64) - np.asarray(b[k], np.float64))
        assert d.max() <= 2 * lr, (k, d.max())
        close += int(np.sum(d <= lr / 10))
        total += d.size
    return close / total


@pytest.mark.parametrize("norm", ["batch", "group"])
@pytest.mark.parametrize("world", WORLDS)
def test_unet2d_mesh_train_matches_jax(runs, world, norm):
    """``UNet2D(mesh=)`` against the JAX package's ``UNet2D(mesh=)`` on its
    mesh of ``world`` devices, from the same weights, dropout 0 and no
    augmentation: one epoch of one step, then two more epochs. Losses at
    rtol 1e-4 (the JAX package's own sharded-against-single tolerance).
    The weights after the first step: at fresh weights many gradients are
    float32 rounding (the Dice gradient is nearly constant over the pixels
    and the norm subtracts it; a conv bias before BatchNorm has none), and
    Adam's first step moves each weight by about lr times its gradient's
    sign, so such a weight may land 2 lr away; 98% are within lr/10."""
    _hold_unet2d_against_jax(runs[0][world][0], f"unet2d_{norm}", _jax_unet2d(norm, world))


def _hold_unet2d_against_jax(res, prefix, jt):
    """``case_unet2d``'s run under ``prefix`` against the JAX trainer
    ``jt`` driven the same way: losses at rtol 1e-4, the weights after
    step 1 by :func:`adam_step1_share`, running statistics at 1e-5."""
    jt.n_epoch = 1
    data = jax_synthetic_ich_slices(**W.UNET2D_DATA)
    jt.train(data)
    first = [row[1] for row in jt.outputs["train"]["evolution"]]
    want_v = unet_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jt._variables()))
    jt.n_epoch = 2
    jt.train(data)
    want = first + [row[1] for row in jt.outputs["train"]["evolution"]]
    np.testing.assert_allclose(res[f"{prefix}/loss"], want, rtol=1e-4)

    got = {k: res[f"{prefix}/step1/{k}"] for k in want_v}
    params = [k for k in want_v if "running" not in k]
    assert adam_step1_share(got, want_v, W.UNET2D_TRAIN["lr"], params) >= 0.98
    for k in want_v:
        if "running" in k:
            np.testing.assert_allclose(got[k], want_v[k], rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("world", [1, 2])
def test_unet2d_mesh_dropout_matches_jax(runs, world):
    """Dropout 0.5 on the BatchNorm net: the JAX package's sharded step
    draws its masks for the global batch (XLA keeps the generator whole),
    and each gloo rank draws its rows of them, so the port at world N
    follows the JAX package's mesh of N devices as with dropout off."""
    jt = _jax_unet2d("batch", world, p_dropout=0.5)
    _hold_unet2d_against_jax(runs[0][world][0], "unet2d_drop", jt)


@pytest.mark.parametrize("world", [2, 4])
def test_unet2d_dropout_world_n_equals_world_1(runs, world):
    """Dropout 0.5: the first block's mask of the first step, gathered over
    the ranks, equals world 1's, and the run holds to world 1's."""
    np.testing.assert_array_equal(runs[0][world][0]["unet2d_drop/mask"],
                                  runs[0][1][0]["unet2d_drop/mask"])
    _hold_world(runs[0], world, "unet2d_drop")


def _hold_world(res, world, prefix):
    """World ``world`` against world 1 under ``prefix``: epoch losses within
    1e-5; the weights after step 1 by :func:`adam_step1_share` (only the
    reduction order differs, yet a gradient that is rounding noise can flip
    its sign), the running statistics within 1e-5."""
    a, b = res[world][0], res[1][0]
    np.testing.assert_allclose(a[f"{prefix}/loss"], b[f"{prefix}/loss"], rtol=1e-5, atol=1e-6)
    keys = [k for k in b if k.startswith(f"{prefix}/step1/")]
    params = [k for k in keys if "running" not in k and "num_batches" not in k]
    assert params
    assert adam_step1_share(a, b, W.LR, params) >= 0.98
    for k in keys:
        if "running" in k:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("sampler", ["True", "False"])
@pytest.mark.parametrize("world", [2, 4])
def test_unet3d_world_n_equals_world_1(runs, world, sampler):
    """The device and the host patch sampler, the default patch
    augmentation, GroupNorm: the global batch's draws, sliced."""
    _hold_world(runs[0], world, f"unet3d_{sampler}")


@pytest.mark.parametrize("kind", ["cr", "global", "local", "frozen"])
@pytest.mark.parametrize("world", [2, 4])
def test_ssl_world_n_equals_world_1(runs, world, kind):
    """Context restoration (the patch swap), global and local contrastive
    (the SimCLR views, the gathered negatives, the region cells) and local
    after a frozen transfer, on BatchNorm nets."""
    _hold_world(runs[0], world, f"ssl_{kind}")


@pytest.mark.parametrize("world", WORLDS)
def test_frozen_transfer_under_mesh(runs, world):
    """The frozen encoder keeps the transferred weights at every world size;
    the other parameters train."""
    res = runs[0][world][0]
    frozen = set(res["ssl_frozen/frozen"].tolist())
    start = {k.split("/frozen_start/")[1]: v for k, v in res.items() if "/frozen_start/" in k}
    final = {k.split("/final/")[1]: v for k, v in res.items() if k.startswith("ssl_frozen/final/")}
    assert frozen and frozen < start.keys()
    for k in frozen:
        np.testing.assert_array_equal(final[k], start[k], err_msg=k)
    trained = [k for k in start if k not in frozen and "running" not in k and "num_batches" not in k]
    assert trained and all(not np.array_equal(final[k], start[k]) for k in trained)


@pytest.mark.parametrize("world", WORLDS)
def test_dcp_checkpoint_cases(runs, world):
    """The JAX package's orbax cases on the DCP store with every rank taking
    part: a missing directory is a fresh start, a round trip keeps values
    and metadata, a crash between the write and the swap restores the new
    state (and the next save promotes it), a rewrite at the same epoch."""
    res = runs[0][world][0]
    for case in ("missing", "roundtrip", "crash", "after_crash", "rewrite"):
        assert bool(res[f"dcp/{case}"]), case


@pytest.mark.parametrize("world", WORLDS)
def test_dcp_elastic_restore(runs, world):
    """A checkpoint that 4 ranks saved restores at 4, 2 and 1 into a fresh
    optimizer: the weights, the Adam moments and the step are world 4's."""
    res, ref = runs[0][world][0], runs[0][4][0]
    keys = [k for k in ref if k.startswith("elastic/")]
    assert any("/opt/" in k for k in keys) and int(res["elastic/epoch"]) == 5
    for k in keys:
        np.testing.assert_array_equal(res[k], ref[k], err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_resume_through_unet2d_train(runs, world):
    """Two epochs into the directory store (a path ending in ``/``), then a
    resume to four: the epoch losses equal four straight epochs (with the
    augmentation drawn for the global batch)."""
    res = runs[0][world][0]
    assert bool(res["resume/dir"])
    assert len(res["resume/straight"]) == 4
    np.testing.assert_array_equal(res["resume/resumed"], res["resume/straight"])


@pytest.mark.parametrize("world", [2, 4])
def test_sigterm_on_one_rank_stops_every_rank(runs, world):
    """SIGTERM on rank 1 only, in epoch 2: every rank stops after epoch 2
    (``test_ranks_agree`` holds the ranks' histories equal), rank 0 wrote
    the one single-file checkpoint at epoch 2, and a resume from it ends
    with the straight run's history."""
    res = runs[0][world][0]
    assert len(res["preempt/history"]) == 2
    np.testing.assert_array_equal(res["preempt/history"], res["resume/straight"][:2])
    assert list(res["preempt/files"]) == ["ckpt.bin"] and int(res["preempt/epoch"]) == 2
    np.testing.assert_array_equal(res["preempt/resumed"], res["resume/straight"])


@pytest.mark.parametrize("world", WORLDS)
def test_segment_volumes_and_evaluate_on_a_mesh(runs, world):
    """``UNet2D`` / ``UNet3D.segment_volumes`` on the mesh (above world 1,
    one volume a rank through ``volume_parallel_map``) equal the trainer
    without a mesh, and the NIfTIs rank 0 wrote hold them; ``evaluate``
    with a save path on every rank writes the CSVs of the trainer without a
    mesh."""
    res = runs[0][world][0]
    for k in ("segment_2d/equal", "segment_3d/equal", "segment_eval/equal"):
        assert bool(res[k]), k


def test_shard_batch_slices_and_refuses_uneven_batches():
    """Each rank's contiguous slice, 0-d leaves whole, and an error naming
    both sizes when the world size does not divide the batch."""
    batch = {"x": np.arange(8 * 3, dtype=np.float32).reshape(8, 3), "w": np.float32(3.0),
             "pair": (torch.arange(8), 5)}
    mesh = parallel.Mesh(None, rank=1, size=4, device=torch.device("cpu"))
    out = parallel.shard_batch(batch, mesh)
    np.testing.assert_array_equal(out["x"].numpy(), batch["x"][2:4])
    assert float(out["w"]) == 3.0 and out["pair"][1] == 5
    assert torch.equal(out["pair"][0], torch.arange(2, 4))
    with pytest.raises(ValueError, match="of 6 does not split over 4"):
        parallel.shard_batch(np.zeros((6, 2)), mesh)
    assert parallel.pad_to_multiple(6, 4) == 8


def test_cuda_mesh_needs_nccl_and_a_card():
    """A CUDA mesh never falls back to gloo: without NCCL or a card,
    ``init_distributed`` raises before it joins a group."""
    with pytest.raises(RuntimeError, match="NCCL|cuda"):
        parallel.init_distributed(device="cuda:0", init_method="file:///nonexistent",
                                  world_size=1, rank=0, timeout=timedelta(seconds=5))
    assert not torch.distributed.is_initialized()
