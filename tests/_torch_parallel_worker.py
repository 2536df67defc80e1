"""One gloo rank of the port's multi-rank tests (``tests/test_torch_parallel.py``).

Usage: python _torch_parallel_worker.py RANK WORLD STORE IN_DIR OUT_DIR

Runs without JAX: jax, flax, optax and ich_tpu are made unimportable before
the port is imported, so every spawned group also shows that the port's
parallel paths need none of them. The rank joins a gloo group through the
file store ``STORE``, runs every case below on the CPU at world ``WORLD``
and writes what it computed to ``OUT_DIR/w{WORLD}_r{RANK}.npz``; the test
holds those against the JAX package and against the world-1 run. Inputs
that come from JAX (carried weights, volumes) are read from
``IN_DIR/inputs.npz``; the checkpoint cases share directories under
``IN_DIR`` between the groups (world 4 saves what worlds 2 and 1 restore).
"""

import os
import signal
import sys
from datetime import timedelta

if __name__ == "__main__":  # the test module imports this file for its constants
    for _name in ("jax", "jaxlib", "flax", "optax", "ich_tpu"):
        sys.modules[_name] = None  # any import of these now raises ImportError

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ich_tpu_torch import parallel  # noqa: E402
from ich_tpu_torch.data.core import VolumeDataset3D  # noqa: E402
from ich_tpu_torch.data.synthetic import synthetic_ich_slices  # noqa: E402
from ich_tpu_torch.interop.from_jax import conv_weight  # noqa: E402
from ich_tpu_torch.models.layers import BatchNorm2d, sync_batch_norm  # noqa: E402
from ich_tpu_torch.models.unet import PartialUNet, UNet, UNetEncoder  # noqa: E402
from ich_tpu_torch.ops.losses import info_nce_loss  # noqa: E402
from ich_tpu_torch.ops.transforms import build_pipeline  # noqa: E402
from ich_tpu_torch.ops.transforms3d import default_patch_augmentation  # noqa: E402
from ich_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from ich_tpu_torch.train import checkpoint_sharded as cks  # noqa: E402
from ich_tpu_torch.train import ssl  # noqa: E402
from ich_tpu_torch.train.segmentation2d import UNet2D  # noqa: E402
from ich_tpu_torch.train.segmentation3d import UNet3D  # noqa: E402
from ich_tpu_torch.train.state import TrainState, make_optimizer  # noqa: E402
from ich_tpu_torch.utils import preemption  # noqa: E402

# shared with the test module
SW_VOL = (10, 30, 12)  # (D, H, W): H splits into uneven slabs at 4 ranks
SW_PATCH = (4, 8, 4)
VPM_VOL = (8, 16, 12)
UNET2D_NET = dict(depth=3, top_filter=8, midchannels_factor=2)
UNET2D_TRAIN = dict(batch_size=8, lr=1e-3, lr_scheduler="ExponentialLR",
                    lr_scheduler_kwargs={"gamma": 0.5}, loss_fn="BinaryDiceLoss",
                    loss_fn_kwargs={"reduction": "mean", "p": 2, "alpha": 0.2},
                    weight_decay=1e-6, seed=0)
UNET2D_DATA = dict(n_slices=8, size=32, n_volumes=2, seed=1, positive_frac=0.6)
SMALL = dict(depth=3, top_filter=4, midchannels_factor=2, p_dropout=0.0)
LR = 1e-3
NCE_SHAPES = dict(n=16, d_in=6, d_out=8)
BN_SHAPE = (8, 3, 5, 5)


class ConvNet(torch.nn.Module):
    """sigmoid(conv3d(x) + b), 'same' padding, the weights of a flax
    ``(3, 3, 3, 1, 2)`` kernel carried by ``from_jax.conv_weight``."""

    def __init__(self, kernel: np.ndarray, bias: np.ndarray):
        super().__init__()
        self.conv = torch.nn.Conv3d(kernel.shape[3], kernel.shape[4], 3, padding=1)
        with torch.no_grad():
            self.conv.weight.copy_(torch.from_numpy(conv_weight(kernel)))
            self.conv.bias.copy_(torch.from_numpy(bias))

    def forward(self, x):
        return torch.sigmoid(self.conv(x))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()  # a CPU tensor's numpy() shares its memory


def _state(net: torch.nn.Module, prefix: str) -> dict:
    return {f"{prefix}/{k}": _np(v) for k, v in net.state_dict().items()}


def _after_first_step(trainer, steps_per_epoch: int, out: dict, prefix: str) -> None:
    """Record the net's weights after the trainer's first Adam step."""
    state = trainer._train_state(steps_per_epoch)
    apply = state.apply_gradients

    def wrapped():
        apply()
        if state.step == 1:
            out.update(_state(state.model, prefix + "/step1"))

    state.apply_gradients = wrapped


def _history(trainer) -> np.ndarray:
    return np.asarray([row[1] for row in trainer.outputs["train"]["evolution"]], np.float64)


# -- cases ------------------------------------------------------------------------

def case_sliding_window(mesh, inp, out):
    net = ConvNet(inp["sw_kernel"], inp["sw_bias"]).eval()
    vol = torch.from_numpy(inp["sw_vol"])
    for name, fn, overlap in (("conv", net, 0.5), ("conv0", net, 0.0),
                              ("identity", lambda x: x, 0.5), ("identity0", lambda x: x, 0.0)):
        res = parallel.sliding_window_inference_sharded(
            fn, vol, mesh, patch_size=SW_PATCH, overlap=overlap, batch_size=4)
        out[f"sw/{name}"] = _np(res)


def case_volume_parallel(mesh, inp, out):
    net = ConvNet(inp["sw_kernel"], inp["sw_bias"]).eval()
    vols = inp["vpm_vols"][:mesh.size + 1]
    out["vpm/sw"] = parallel.sliding_window_inference_volume_parallel(
        net, vols, mesh, patch_size=SW_PATCH, overlap=0.5, batch_size=4)
    double = list(parallel.volume_parallel_map(lambda v: torch.from_numpy(v) * 2 + 1,
                                               list(vols), mesh))
    out["vpm/double"] = np.stack(double)
    out["vpm/empty"] = np.asarray(len(list(parallel.volume_parallel_map(
        lambda v: torch.from_numpy(v), [], mesh))))


def case_info_nce(mesh, inp, out):
    """z = x @ w on each rank's slice of both views, the gathered loss,
    backward and the gradient mean of the trainers."""
    w = torch.nn.Parameter(torch.from_numpy(inp["nce_w"]))
    x1, x2 = parallel.shard_batch((inp["nce_x1"], inp["nce_x2"]), mesh)
    loss = info_nce_loss(x1 @ w, x2 @ w, tau=0.5, mesh=mesh)
    loss.backward()
    parallel.average_gradients([w], mesh)
    out["nce/loss"] = _np(loss)
    out["nce/grad"] = _np(w.grad)


def case_batch_norm(mesh, inp, out):
    bn = BatchNorm2d(BN_SHAPE[1], eps=1e-5, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(inp["bn_scale"]))
        bn.bias.copy_(torch.from_numpy(inp["bn_bias"]))
        bn.running_mean.copy_(torch.from_numpy(inp["bn_mean"]))
        bn.running_var.copy_(torch.from_numpy(inp["bn_var"]))
    sync_batch_norm(bn, mesh).train()
    x, r = parallel.shard_batch((inp["bn_x"], inp["bn_r"]), mesh)
    x.requires_grad_(True)
    y = bn(x)
    (y * r).sum().backward()
    out["bn/y"] = _np(parallel.all_gather(y.detach(), mesh))
    out["bn/dx"] = _np(parallel.all_gather(x.grad, mesh))
    out["bn/mean"], out["bn/var"] = _np(bn.running_mean), _np(bn.running_var)


def case_unet2d(mesh, inp, out):
    """UNet2D.train from the JAX package's weights: one epoch of one step,
    then ``train`` again for two epochs (the state carried on), as the
    test drives the JAX trainer."""
    data = synthetic_ich_slices(**UNET2D_DATA).device_cache("cpu")
    for norm in ("batch", "group"):
        net = UNet(p_dropout=0.0, norm=norm, **UNET2D_NET)
        net.load_state_dict(torch.load(os.path.join(inp["_dir"], f"unet2d_{norm}.pt")))
        t = UNet2D(net, mesh=mesh, **{**UNET2D_TRAIN, "n_epoch": 1})
        t.train(data)
        first = _history(t)
        out.update(_state(t.unet, f"unet2d_{norm}/step1"))
        t.n_epoch = 2
        t.train(data)
        out[f"unet2d_{norm}/loss"] = np.concatenate([first, _history(t)])


def case_unet2d_dropout(mesh, inp, out):
    """``case_unet2d``'s BatchNorm run at dropout 0.5, with the first
    block's mask of the first step gathered over the ranks."""
    data = synthetic_ich_slices(**UNET2D_DATA).device_cache("cpu")
    net = UNet(p_dropout=0.5, norm="batch", **UNET2D_NET)
    net.load_state_dict(torch.load(os.path.join(inp["_dir"], "unet2d_batch.pt")))
    masks = []
    hook = net.down_block[0].dropout.register_forward_hook(
        lambda m, args, y: masks.append((y.detach() != 0).to(torch.float32)))
    t = UNet2D(net, mesh=mesh, **{**UNET2D_TRAIN, "n_epoch": 1})
    t.train(data)
    hook.remove()
    out["unet2d_drop/mask"] = _np(parallel.all_gather(masks[0], mesh))
    first = _history(t)
    out.update(_state(t.unet, "unet2d_drop/step1"))
    t.n_epoch = 2
    t.train(data)
    out["unet2d_drop/loss"] = np.concatenate([first, _history(t)])


def _volumes3d():
    rng = np.random.default_rng(0)
    vols, masks = [], []
    for d, h, w in ((20, 32, 32), (18, 24, 28)):
        zz, yy, xx = np.meshgrid(np.arange(d), np.arange(h), np.arange(w), indexing="ij")
        c, r = rng.uniform(0.3, 0.7, 3) * (d, h, w), rng.uniform(3, 6, 3)
        m = ((((zz - c[0]) / r[0]) ** 2 + ((yy - c[1]) / r[1]) ** 2
              + ((xx - c[2]) / r[2]) ** 2) <= 1).astype(np.float32)
        v = 0.35 + 0.08 * rng.standard_normal((d, h, w))
        vols.append(np.clip(np.where(m > 0, 0.75, v), 0, 1).astype(np.float32))
        masks.append(m)
    return VolumeDataset3D(vols, masks, np.asarray([3, 7]))


def case_unet3d(mesh, inp, out):
    """Both samplers, the default patch augmentation: world N against 1."""
    data = _volumes3d()
    for sampler in (True, False):
        torch.manual_seed(0)
        net = UNet(ndim=3, depth=3, top_filter=4, midchannels_factor=1, norm="group",
                   p_dropout=0.0)
        t = UNet3D(net, patch_size=(8, 16, 16), steps_per_epoch=3, pos_frac=0.5, n_epoch=1,
                   batch_size=4, lr=LR, loss_fn="BinaryDiceLoss",
                   loss_fn_kwargs={"reduction": "mean", "p": 2, "alpha": 0.2}, seed=0,
                   augment_fn=default_patch_augmentation(flip_axes=(1, 2, 3)),
                   on_device_sampling=sampler, mesh=mesh)
        _after_first_step(t, 3, out, f"unet3d_{sampler}")
        t.train(data)
        out[f"unet3d_{sampler}/loss"] = _history(t)


def _ssl_trainer(kind, mesh, n_epoch=2, **kw):
    torch.manual_seed(0)
    common = dict(n_epoch=n_epoch, batch_size=8, lr=LR, seed=1, mesh=mesh, **kw)
    if kind == "cr":
        return ssl.ContextRestoration(UNet(use_final_activation=False, norm="batch", **SMALL),
                                      n_swap=3, swap_w=(4, 8), swap_h=(4, 8), **common)
    if kind == "global":
        return ssl.Contrastive(UNetEncoder(mlp_head=(16, 8), **SMALL), **common)
    t = ssl.Contrastive(PartialUNet(n_decoder=1, head_channel=(8, 4), **SMALL),
                        is_global=False, K=2, n_region=4, **common)
    if kind == "frozen":
        torch.manual_seed(1)
        t.transfer_weights(UNetEncoder(mlp_head=(16, 8), **SMALL).state_dict(), freeze=True)
    return t


def case_ssl(mesh, inp, out):
    """The real draws (patch swap; the SimCLR views; region cells), BatchNorm
    nets: world N against 1, and a frozen transfer under the mesh."""
    data = synthetic_ich_slices(n_slices=16, size=32, n_volumes=2, seed=4).device_cache("cpu")
    for kind in ("cr", "global", "local", "frozen"):
        t = _ssl_trainer(kind, mesh)
        before = _state(t.net, f"ssl_{kind}/start")
        _after_first_step(t, 2, out, f"ssl_{kind}")
        t.train(data)
        out[f"ssl_{kind}/loss"] = _history(t)
        out.update(_state(t.net, f"ssl_{kind}/final"))
        if kind == "frozen":
            out["ssl_frozen/frozen"] = np.asarray(sorted(t.frozen))
            out.update({k.replace("/start/", "/frozen_start/"): v for k, v in before.items()})


def case_dcp(mesh, inp, out):
    """The crash-safety cases of the JAX package's orbax store, every rank
    taking part; then the elastic restore: world 4 saves a trained state
    that worlds 2 and 1 restore into a fresh optimizer."""
    root = os.path.join(inp["_out"], f"dcp_w{mesh.size}")
    out["dcp/missing"] = np.asarray(cks.load_checkpoint_sharded(
        os.path.join(root, "nope"), mesh) is None)

    state = {"params": {"w": torch.arange(32.0).reshape(8, 4), "b": torch.ones(4)},
             "step": torch.tensor(7), "note": "seven"}
    path = os.path.join(root, "ckpt")
    cks.save_checkpoint_sharded(path, state, 3, [[1, 0.5]], mesh)
    restored, epoch, history = cks.load_checkpoint_sharded(path, mesh)
    out["dcp/roundtrip"] = np.asarray(
        epoch == 3 and history == [[1, 0.5]] and restored["note"] == "seven"
        and torch.equal(restored["params"]["w"], state["params"]["w"])
        and torch.equal(restored["params"]["b"], state["params"]["b"])
        and int(restored["step"]) == 7)

    path = os.path.join(root, "crash")
    cks.save_checkpoint_sharded(path, {"w": torch.full((4,), 2.0)}, 1, [[1, 0.9]], mesh)
    if mesh.rank == 0:  # the crash window: the finished save exists only as state.new
        os.rename(os.path.join(path, "state"), os.path.join(path, "state.new"))
    parallel.barrier(mesh)
    restored, epoch, _ = cks.load_checkpoint_sharded(path, mesh)
    out["dcp/crash"] = np.asarray(epoch == 1 and torch.equal(restored["w"], torch.full((4,), 2.0)))
    # the next save promotes state.new before it writes
    cks.save_checkpoint_sharded(path, {"w": torch.full((4,), 3.0)}, 2, [], mesh)
    restored, epoch, _ = cks.load_checkpoint_sharded(path, mesh)
    out["dcp/after_crash"] = np.asarray(
        epoch == 2 and torch.equal(restored["w"], torch.full((4,), 3.0))
        and not os.path.exists(os.path.join(path, "state.new")))

    path = os.path.join(root, "rewrite")
    cks.save_checkpoint_sharded(path, {"w": torch.zeros(4)}, 1, [], mesh)
    cks.save_checkpoint_sharded(path, {"w": torch.ones(4)}, 1, [[1, 1.0]], mesh)
    restored, epoch, history = cks.load_checkpoint_sharded(path, mesh)
    out["dcp/rewrite"] = np.asarray(epoch == 1 and history == [[1, 1.0]]
                                    and torch.equal(restored["w"], torch.ones(4)))

    elastic = os.path.join(inp["_dir"], "elastic") + "/"
    net = UNet(norm="batch", **SMALL)
    opt = make_optimizer(net.parameters(), LR, weight_decay=1e-6)
    state = TrainState(net, opt, lambda step: LR, mesh=mesh)
    if mesh.size == 4:
        torch.manual_seed(0)
        for p in net.parameters():
            p.grad = torch.randn_like(p)
        state.apply_gradients()
        ckpt.save_checkpoint_auto(elastic, state.state_dict(), 5, [[5, 0.25]], mesh)
    restored = ckpt.load_checkpoint_auto(elastic, mesh)
    state.load_state_dict(restored[0])
    out["elastic/epoch"] = np.asarray(restored[1])
    out.update(_state(net, "elastic/model"))
    for i, s in state.optimizer.state_dict()["state"].items():
        for k, v in s.items():
            out[f"elastic/opt/{i}/{k}"] = _np(v)
    out["elastic/step"] = np.asarray(state.step)


def case_segment(mesh, inp, out):
    """``segment_volumes`` of both trainers on the mesh (one volume a rank
    above world 1) against the trainer without a mesh, NIfTIs written by
    rank 0; ``evaluate`` with a save path on every rank."""
    from ich_tpu_torch.data import nifti

    root = os.path.join(inp["_out"], f"segment_w{mesh.size}")
    rng = np.random.default_rng(5)
    vols2d = [rng.uniform(-100, 150, (24, 20, 5)).astype(np.float32) for _ in range(3)]
    vols3d = [rng.uniform(size=(12, 16, 16)).astype(np.float32) for _ in range(3)]
    for label, make, vols, kw in (
            ("2d", lambda m: UNet2D(UNet(norm="batch", **SMALL), batch_size=4, mesh=m,
                                    device="cpu"), vols2d,
             dict(window=(40.0, 80.0), input_size=(16, 16))),
            ("3d", lambda m: UNet3D(UNet(ndim=3, depth=2, top_filter=4, norm="group",
                                         p_dropout=0.0), patch_size=(8, 8, 8), mesh=m,
                                    device="cpu"), vols3d, {})):
        torch.manual_seed(0)
        plain = make(None)
        torch.manual_seed(0)
        t = make(mesh)
        with torch.no_grad():  # weights that leave both classes in the masks
            for net in (plain.unet, t.unet):
                net.final_conv.bias.fill_(float(np.log(0.25)))
                for name, b in net.named_buffers():
                    if name.endswith("running_var"):
                        b.fill_(0.01)
        fns = [os.path.join(root, label, f"v{i}.nii.gz") for i in range(3)]
        got = t.segment_volumes(vols, save_fns=fns, return_preds=True, **kw)
        want = plain.segment_volumes(vols, return_preds=True, **kw)
        parallel.barrier(mesh)
        out[f"segment_{label}/equal"] = np.asarray(
            all(np.array_equal(a, b) for a, b in zip(got, want))
            and all(np.array_equal(nifti.load(f)[0], b) for f, b in zip(fns, want))
            and 0 < np.mean(want[0]) < 255)
    data = synthetic_ich_slices(n_slices=10, size=16, n_volumes=2, seed=6)
    torch.manual_seed(0)
    plain = UNet2D(UNet(norm="batch", **SMALL), batch_size=4, device="cpu")
    torch.manual_seed(0)
    t = UNet2D(UNet(norm="batch", **SMALL), batch_size=4, device="cpu", mesh=mesh)
    t.evaluate(data, save_path=os.path.join(root, "eval"))
    parallel.barrier(mesh)
    plain_dir = os.path.join(root, f"eval_plain_r{mesh.rank}")
    plain.evaluate(data, save_path=plain_dir)
    same = all(open(os.path.join(root, "eval", name)).read()
               == open(os.path.join(plain_dir, name)).read()
               for name in ("slice_prediction_scores.csv", "volume_prediction_scores.csv"))
    out["segment_eval/equal"] = np.asarray(same and t.outputs["eval"]["dice"]
                                           == plain.outputs["eval"]["dice"])


def _unet2d_run(mesh, n_epoch, path=None, step_hook=None):
    torch.manual_seed(0)
    data = synthetic_ich_slices(n_slices=16, size=32, n_volumes=2, seed=3).device_cache("cpu")
    kw = {**UNET2D_TRAIN, "n_epoch": n_epoch, "checkpoint_freq": 1 if path and
          path.endswith("/") else 10,
          "augment_fn": build_pipeline({"HFlip": {"p": 0.5}, "Rotate": {"low": -10, "high": 10}})}
    t = UNet2D(UNet(p_dropout=0.0, norm="batch", **UNET2D_NET), mesh=mesh, **kw)
    if step_hook is not None:
        step = t._train_step
        t._train_step = lambda state, batch, seed: step_hook(state) or step(state, batch, seed)
    t.train(data, checkpoint_path=path)
    return t


def case_resume(mesh, inp, out):
    """A resume through UNet2D.train from the directory store equals the
    straight run; then SIGTERM on rank 1 only stops every rank after the
    same epoch with one single-file checkpoint, which resumes."""
    straight = _history(_unet2d_run(mesh, 4))
    root = os.path.join(inp["_out"], f"resume_w{mesh.size}")
    _unet2d_run(mesh, 2, os.path.join(root, "ck") + "/")
    out["resume/dir"] = np.asarray(os.path.isdir(os.path.join(root, "ck", "state")))
    resumed = _unet2d_run(mesh, 4, os.path.join(root, "ck") + "/")
    out["resume/straight"], out["resume/resumed"] = straight, _history(resumed)

    if mesh.size < 2:
        return
    path = os.path.join(root, "pre", "ckpt.bin")

    def preempt(state):
        if mesh.rank == 1 and state.step == 2:  # the first step of the second epoch
            os.kill(os.getpid(), signal.SIGTERM)

    stopped = _unet2d_run(mesh, 4, path, preempt)
    out["preempt/history"] = _history(stopped)
    out["preempt/requested"] = np.asarray(preemption.requested())
    out["preempt/files"] = np.asarray(sorted(os.listdir(os.path.dirname(path))))
    out["preempt/epoch"] = np.asarray(ckpt.load_checkpoint(path)[1])
    preemption.reset()
    out["preempt/resumed"] = _history(_unet2d_run(mesh, 4, path))


CASES = (case_sliding_window, case_volume_parallel, case_info_nce, case_batch_norm,
         case_unet2d, case_unet2d_dropout, case_unet3d, case_ssl, case_dcp, case_resume, case_segment)


def main() -> None:
    rank, world, store, in_dir, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    mesh = parallel.init_distributed(device="cpu", init_method=f"file://{store}",
                                     world_size=world, rank=rank,
                                     timeout=timedelta(seconds=120))
    inp = dict(np.load(os.path.join(in_dir, "inputs.npz")))
    inp["_dir"], inp["_out"] = in_dir, out_dir
    out: dict = {}
    for case in CASES:
        case(mesh, inp, out)
    np.savez(os.path.join(out_dir, f"w{world}_r{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
