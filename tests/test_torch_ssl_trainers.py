"""The port's SSL trainers against the JAX package's, from the same
flax-initialised weights carried by ``interop.from_jax``, with the random
parts injected: the patch-swap geometry JAX draws, two fixed views, and the
same region cells. Held: the batch plans (equal), the step-1 loss (rtol
1e-5) and the losses of the next steps (rtol 1e-4: Adam's first steps move
weights whose gradients are float32 rounding by up to the learning rate in
either package, which the loss feels in its fifth digit), the frozen
encoder after local training (equal to the transferred weights in both
packages) and its running statistics (moved). Then the port alone: a
resumed run bit-equal to a straight one, and the repairs of
``load_model(image_shape=...)`` and of 2.5D inference in eval mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ich_tpu.train.ssl as jax_ssl
from ich_tpu.data import synthetic_ich_slices as jax_synthetic_ich_slices
from ich_tpu.models import PartialUNet as JaxPartialUNet
from ich_tpu.models import UNet as JaxUNet
from ich_tpu.models import UNetEncoder as JaxUNetEncoder
from ich_tpu.ops import losses as JL
from ich_tpu.ops import transforms as JT
import ich_tpu_torch.train.ssl as ssl
from ich_tpu_torch.data.synthetic import synthetic_ich_slices
from ich_tpu_torch.interop.from_jax import (
    partial_unet_state_dict_from_jax,
    unet_encoder_state_dict_from_jax,
    unet_state_dict_from_jax,
)
from ich_tpu_torch.models.unet import PartialUNet, UNet, UNetEncoder
from ich_tpu_torch.ops import losses as L
from ich_tpu_torch.ops import transforms as T
from ich_tpu_torch.train.segmentation2d import UNet2D
from ich_tpu_torch.train.segmentation3d import UNet3D

torch.set_num_threads(2)

SMALL = dict(depth=3, top_filter=4, midchannels_factor=2, p_dropout=0.0)
TRAIN = dict(n_epoch=2, batch_size=8, lr=1e-3, seed=0)
HW = (32, 32)


def _data(seed):
    port = synthetic_ich_slices(n_slices=16, size=32, n_volumes=2, seed=seed)
    np.testing.assert_array_equal(port.images, jax_synthetic_ich_slices(16, 32, 2, seed=seed).images)
    return port


def _sd(variables, convert):
    return {k: torch.from_numpy(np.array(a)) for k, a in convert(variables).items()}


def _variables(trainer):
    return jax.tree_util.tree_map(np.array, trainer._variables())


def _record(monkeypatch, jt, pt):
    """Per-step losses and batch plans of both trainers."""
    rec = {"jax": [], "port": [], "jax_plan": [], "port_plan": []}
    make = jt._make_train_step

    def make_recording():
        step = make()

        def run(state, batch, key):
            state, loss = step(state, batch, key)
            rec["jax"].append(float(loss))
            return state, loss

        return run

    jt._make_train_step = make_recording
    port_step = pt._step

    def run_port(state, images, gen):
        loss = port_step(state, images, gen)
        rec["port"].append(float(loss))
        return loss

    pt._step = run_port
    for mod, key in ((jax_ssl, "jax_plan"), (ssl, "port_plan")):
        orig = mod.batch_indices

        def recording(*a, orig=orig, key=key, **kw):
            plan = list(orig(*a, **kw))
            rec[key].append(np.stack(plan))
            return iter(plan)

        monkeypatch.setattr(mod, "batch_indices", recording)
    return rec


def _check(rec, steps):
    assert len(rec["jax_plan"]) == len(rec["port_plan"]) == TRAIN["n_epoch"]
    for a, b in zip(rec["jax_plan"], rec["port_plan"]):
        np.testing.assert_array_equal(a, b)
    assert len(rec["jax"]) == len(rec["port"]) == steps
    np.testing.assert_allclose(rec["port"][0], rec["jax"][0], rtol=1e-5)
    np.testing.assert_allclose(rec["port"], rec["jax"], rtol=1e-4)


def test_context_restoration_matches_jax(monkeypatch):
    """Both packages corrupt with the geometry JAX draws from one fixed
    key (the same for every step), restore and take Adam steps."""
    data = _data(1)
    jt = jax_ssl.ContextRestoration(JaxUNet(use_final_activation=False, **SMALL), n_swap=3,
                                    swap_w=(4, 8), swap_h=(4, 8), swap_rotate=True, **TRAIN)
    jt._ensure_state(HW, 2)
    net = UNet(use_final_activation=False, **SMALL)
    net.load_state_dict(_sd(_variables(jt), unet_state_dict_from_jax))
    pt = ssl.ContextRestoration(net, n_swap=3, swap_w=(4, 8), swap_h=(4, 8), device="cpu",
                                **TRAIN)
    jswap, key = JT.RandomPatchSwap(n=3, w=(4, 8), h=(4, 8), rotate=True), jax.random.PRNGKey(5)
    keys = jax.vmap(lambda kb: jax.random.split(kb, 3))(jax.random.split(key, 8))
    geom = tuple(torch.from_numpy(np.array(g)).long()
                 for g in jax.vmap(jax.vmap(lambda k: jswap._sample_geom(k, HW)))(keys))
    jt.corrupt = lambda k, x: jswap(key, x)
    pt.corrupt = lambda gen, x: pt_swap.apply(x, geom)
    pt_swap = T.RandomPatchSwap(n=3, w=(4, 8), h=(4, 8), rotate=True)
    rec = _record(monkeypatch, jt, pt)
    jt.train(jax_synthetic_ich_slices(16, 32, 2, seed=1))
    pt.train(data)
    _check(rec, 4)
    assert not pt.net.training
    assert rec["port"][-1] < rec["port"][0]  # the restoration error falls


class _Views:
    """Two fixed views, alternating call by call: the step's first call
    gives the batch, the second its left-right mirror."""

    def __init__(self, flip):
        self.flip, self.calls = flip, 0

    def __call__(self, key, x):
        self.calls += 1
        return x if self.calls % 2 else self.flip(x)


def test_global_contrastive_matches_jax(monkeypatch):
    data = _data(2)
    enc_kw = dict(mlp_head=(16, 8), **SMALL)
    jt = jax_ssl.Contrastive(JaxUNetEncoder(**enc_kw), is_global=True, tau=0.5,
                             aug_pipeline=_Views(lambda x: x[:, :, ::-1]), **TRAIN)
    jt._ensure_state(HW, 2)
    net = UNetEncoder(**enc_kw)
    net.load_state_dict(_sd(_variables(jt), unet_encoder_state_dict_from_jax))
    pt = ssl.Contrastive(net, is_global=True, tau=0.5,
                         aug_pipeline=_Views(lambda x: torch.flip(x, dims=[2])), device="cpu",
                         **TRAIN)
    rec = _record(monkeypatch, jt, pt)
    jt.train(jax_synthetic_ich_slices(16, 32, 2, seed=2))
    pt.train(data)
    _check(rec, 4)
    assert abs(rec["port"][0] - np.log(2 * 8 - 1)) < 1.0  # NT-Xent starts near ln(2N - 1)


def test_local_contrastive_with_frozen_encoder_matches_jax(monkeypatch):
    """The encoder transferred and frozen in both packages: after training
    its weights equal the transferred ones bit for bit (in both), its
    running statistics moved, and the decoder and head trained."""
    data = _data(3)
    enc_kw = dict(mlp_head=(16, 8), **SMALL)
    part_kw = dict(n_decoder=1, head_channel=(8, 4), **SMALL)
    enc_vars = jax.tree_util.tree_map(np.array, JaxUNetEncoder(**enc_kw).init(
        jax.random.PRNGKey(7), jnp.zeros((1,) + HW + (1,))))
    jt = jax_ssl.Contrastive(JaxPartialUNet(**part_kw), is_global=False, tau=0.5, K=2,
                             n_region=4, aug_pipeline=_Views(lambda x: x[:, :, ::-1]), **TRAIN)
    jt._ensure_state(HW, 2)
    jmoved = jt.transfer_weights(enc_vars, freeze=True)
    net = PartialUNet(**part_kw)
    net.load_state_dict(_sd(_variables(jt), partial_unet_state_dict_from_jax))
    pt = ssl.Contrastive(net, is_global=False, tau=0.5, K=2, n_region=4,
                         aug_pipeline=_Views(lambda x: torch.flip(x, dims=[2])), device="cpu",
                         **TRAIN)
    enc_sd = _sd(enc_vars, unet_encoder_state_dict_from_jax)
    moved = pt.transfer_weights(enc_sd, freeze=True, verbose=True)
    assert len([k for k in moved if "num_batches" not in k]) == len(jmoved) + sum(
        "running" in k for k in moved)
    assert pt.frozen and all(k.startswith(("down_block", "bottleneck_block")) for k in pt.frozen)
    cells = np.stack([np.random.default_rng(i).permutation(64)[:4] for i in range(8)])
    monkeypatch.setattr(JL, "sample_region_cells", lambda k, b, g, r: jnp.asarray(cells))
    monkeypatch.setattr(L, "sample_region_cells", lambda gen, b, g, r: torch.from_numpy(cells))
    before = {k: v.clone() for k, v in pt.net.state_dict().items()}
    j_before = _variables(jt)
    rec = _record(monkeypatch, jt, pt)
    jt.train(jax_synthetic_ich_slices(16, 32, 2, seed=3))
    pt.train(data)
    _check(rec, 4)
    after = pt.net.state_dict()
    for k in pt.frozen:
        assert torch.equal(after[k], enc_sd[k]), k
    assert not torch.equal(after["down_block.0.bn1.running_mean"],
                           before["down_block.0.bn1.running_mean"])
    for k in ("up_block.0.conv1.weight", "up_samp.0.weight", "final_conv.conv_layers.1.weight"):
        assert not torch.equal(after[k], before[k]), k
    j_after = _variables(jt)
    enc = j_after["params"]["encoder"]
    np.testing.assert_array_equal(enc["down_0"]["conv1"]["kernel"],
                                  enc_vars["params"]["encoder"]["down_0"]["conv1"]["kernel"])
    assert not np.array_equal(j_after["batch_stats"]["encoder"]["down_0"]["bn1"]["norm"]["mean"],
                              j_before["batch_stats"]["encoder"]["down_0"]["bn1"]["norm"]["mean"])


@pytest.mark.parametrize("kind", ["cr", "global", "local"])
def test_resume_equals_straight_run(tmp_path, kind):
    """The real draws (patch swap; the default SimCLR views with crop,
    flip, blur, brightness and contrast; region cells): two epochs, a
    checkpoint, a resume to three, bit-equal to three straight epochs;
    the frozen set is rebuilt the same way for the resume."""
    data = synthetic_ich_slices(n_slices=12, size=32, n_volumes=2, seed=4).device_cache("cpu")

    def make(n_epoch, **kw):
        torch.manual_seed(0)
        common = dict(n_epoch=n_epoch, batch_size=4, seed=1, device="cpu", **kw)
        if kind == "cr":
            return ssl.ContextRestoration(UNet(use_final_activation=False, **SMALL), n_swap=3,
                                          swap_w=(4, 8), swap_h=(4, 8), **common)
        if kind == "global":
            return ssl.Contrastive(UNetEncoder(mlp_head=(16, 8), **SMALL), **common)
        t = ssl.Contrastive(PartialUNet(n_decoder=1, head_channel=(8, 4), **SMALL),
                            is_global=False, K=2, n_region=4, **common)
        torch.manual_seed(1)
        t.transfer_weights(UNetEncoder(mlp_head=(16, 8), **SMALL).state_dict(), freeze=True)
        return t

    path = str(tmp_path / "ckpt.bin")
    make(2, checkpoint_freq=2).train(data, checkpoint_path=path)
    resumed = make(3)
    resumed.train(data, checkpoint_path=path)
    straight = make(3)
    straight.train(data)
    assert resumed.outputs["train"]["evolution"] == straight.outputs["train"]["evolution"]
    assert resumed.state.step == straight.state.step == 9
    for (k, a), b in zip(resumed.net.state_dict().items(), straight.net.state_dict().values()):
        assert torch.equal(a, b), k
    assert all(np.isfinite(row[1]) for row in straight.outputs["train"]["evolution"])


def test_load_model_takes_image_shape(tmp_path):
    """The JAX API's ``load_model(import_fn, image_shape=...)`` on the 2D, 3D
    and SSL trainers (the keyword used to raise ``TypeError``)."""
    trainers = [
        UNet2D(UNet(**SMALL), device="cpu"),
        UNet3D(UNet(ndim=3, depth=2, top_filter=4, p_dropout=0.0), patch_size=(8, 8, 8),
               device="cpu"),
        ssl.ContextRestoration(UNet(use_final_activation=False, **SMALL), device="cpu"),
    ]
    for t in trainers:
        net = getattr(t, "unet", None) or t.net
        fn = str(tmp_path / f"{type(t).__name__}.pt")
        t.save_model(fn)
        with torch.no_grad():
            for p in net.parameters():
                p.add_(1.0)
        t.load_model(fn, image_shape=(64, 64))
        t.load_model(fn, (32, 32))
        reloaded = torch.load(fn, weights_only=True)
        for k, v in net.state_dict().items():
            assert torch.equal(v, reloaded[k]), k


def test_segment_volume_runs_in_eval_mode():
    """A net left in train mode (dropout 0.5, batch statistics) segments as
    in eval mode, and is left in train mode afterwards."""
    torch.manual_seed(0)
    t = UNet2D(UNet(depth=3, top_filter=4, p_dropout=0.5), batch_size=4, device="cpu")
    with torch.no_grad():
        t.unet.final_conv.bias.fill_(-0.01)  # about half the voxels positive
    vol = np.random.default_rng(0).uniform(-50, 150, size=(40, 36, 6)).astype(np.float32)
    kw = dict(window=(50, 200), input_size=(32, 32), return_pred=True)
    want = t.segment_volume(vol, **kw)
    t.unet.train()
    got = t.segment_volume(vol, **kw)
    assert t.unet.training
    np.testing.assert_array_equal(got, want)
    both = t.segment_volumes([vol, vol], window=(50, 200), input_size=(32, 32),
                             return_preds=True)
    assert t.unet.training and all(np.array_equal(p, want) for p in both)
    assert 0 < (want == 255).mean() < 1
