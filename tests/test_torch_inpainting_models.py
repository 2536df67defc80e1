"""The port's SN-PatchGAN networks (ich_tpu_torch.models.inpainting) against
ich_tpu.models.inpainting with carried weights, on numpy-seeded inputs.

Tolerances: every layer, both generators and the discriminator at atol 1e-4
(float32; the train-mode nets normalise tiny activations, which scales their
rounding up to about 2e-5); the spectral-norm ``u`` and ``sigma`` and the
BatchNorm running statistics at atol 1e-5; reflect padding, patch
extraction and the remat gradients exact."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from ich_tpu.models import inpainting as J  # noqa: E402
from ich_tpu_torch.interop import from_jax as FJ  # noqa: E402
from ich_tpu_torch.models import inpainting as P  # noqa: E402
from ich_tpu_torch.utils.config import NETWORKS  # noqa: E402

ATOL = 1e-4
STATS_ATOL = 1e-5


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), dict(tree))


def _load(net, sd):
    net.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v in sd.items()}, strict=True)
    return net


def _inputs(size, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(size=(batch, size, size, 1)).astype(np.float32)
    mask = np.zeros((batch, size, size, 1), np.float32)
    mask[:, size // 4: size // 2, size // 3: 3 * size // 4] = 1.0
    mask[1, -size // 4:, : size // 4] = 1.0
    return img, mask


def _calibrated(v, new_stats):
    """``batch_stats`` set to the batch statistics of one train-mode call
    (flax's update ``0.9 old + 0.1 batch`` solved for ``batch``), so that the
    eval-mode net sees activations of the scale it was normalised at."""
    stats = jax.tree_util.tree_map(lambda old, new: (np.asarray(new) - 0.9 * old) / 0.1,
                                   v["batch_stats"], _np_tree(new_stats))
    return {**v, "batch_stats": stats}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


@pytest.mark.parametrize("n,pad", [(8, 16), (8, 7), (3, 10), (1, 3), (5, 16), (32, 16)])
def test_pad_reflect_is_numpy_reflect_for_any_width(n, pad):
    x = torch.arange(2 * n * n, dtype=torch.float32).reshape(1, 2, n, n)
    want = np.pad(x.numpy(), ((0, 0), (0, 0), (pad, pad), (pad, pad)), mode="reflect")
    assert np.array_equal(P.pad_reflect(x, pad).numpy(), want)
    jx = np.asarray(J._pad_reflect(jnp.asarray(np.transpose(x.numpy(), (0, 2, 3, 1))), pad))
    assert np.array_equal(np.transpose(want, (0, 2, 3, 1)), jx)


@pytest.mark.parametrize("dilation,padding,up", [(1, 1, False), (16, 16, False), (1, 1, True)])
@pytest.mark.parametrize("train", [True, False])
def test_gated_conv_layers_match_jax(dilation, padding, up, train):
    """GatedConv2d (the dilation-16 layer on an 8x8 map pads past the side)
    and UpsampleGatedConv2d, with BatchNorm on the feature half."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 8, 6)).astype(np.float32)
    cls = J.UpsampleGatedConv2d if up else J.GatedConv2d
    jn = cls(features=5, dilation=dilation, padding=padding, activation="lrelu")
    v = _np_tree(jn.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    stats = v["batch_stats"]["gconv" if up else "norm"]
    node = stats["norm"] if up else stats
    node["mean"] = rng.normal(size=5).astype(np.float32) * 0.1
    node["var"] = rng.uniform(0.5, 1.5, size=5).astype(np.float32)
    pn = (P.UpsampleGatedConv2d if up else P.GatedConv2d)(6, 5, dilation=dilation,
                                                          padding=padding, activation="lrelu")
    e = FJ._Emitter(v)
    if up:
        e.conv("gconv/conv", "gated_conv.conv")
        e.norm("gconv/norm", "gated_conv.norm")
    else:
        e.conv("conv", "conv")
        e.norm("norm", "norm")
    _load(pn, e.sd).train(train)
    if train:
        jo, new = jn.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        jo = jn.apply(v, jnp.asarray(x), train=False)
    po = pn(_nchw(x)).detach().permute(0, 2, 3, 1)
    _close(po, jo)
    if train:
        jnew = new["batch_stats"]["gconv"]["norm"] if up else new["batch_stats"]["norm"]
        bn = pn.gated_conv.norm if up else pn.norm
        _close(bn.running_mean, jnew["mean"], STATS_ATOL)
        _close(bn.running_var, jnew["var"], STATS_ATOL)


@pytest.mark.parametrize("train", [True, False])
def test_sn_conv_matches_flax_spectral_norm(train):
    """One power step from the stored u on every call; only train mode
    stores u and sigma."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 12, 12, 3)).astype(np.float32)
    jn = J.SNConv2d(features=7, kernel_size=5, stride=2, padding=2)
    v = _np_tree(jn.init(jax.random.PRNGKey(3), jnp.asarray(x)))
    e = FJ._Emitter(v)
    e.conv("conv", "conv")
    e.norm("norm", "norm")
    sd = dict(e.sd)
    spec = FJ._flat(v["spectral_stats"])
    sd["u"], sd["sigma"] = spec["SpectralNorm_0/conv/kernel/u"], spec["SpectralNorm_0/conv/kernel/sigma"]
    p = _load(P.SNConv2d(3, 7, 5, stride=2, padding=2), sd).train(train)
    u_before = p.u.clone()
    if train:
        jo, new = jn.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats", "spectral_stats"])
    else:
        jo = jn.apply(v, jnp.asarray(x), train=False)
    po = p(_nchw(x)).detach().permute(0, 2, 3, 1)
    _close(po, jo)
    if train:
        jspec = FJ._flat(_np_tree(new)["spectral_stats"])
        _close(p.u, jspec["SpectralNorm_0/conv/kernel/u"], STATS_ATOL)
        _close(p.sigma, jspec["SpectralNorm_0/conv/kernel/sigma"], STATS_ATOL)
        assert not torch.equal(p.u, u_before)
    else:
        assert torch.equal(p.u, u_before)


def test_sn_conv_is_not_torch_spectral_norm():
    """torch's spectral_norm does not iterate in eval mode; flax's (and the
    port's) takes a power step on every call, so two eval calls from a
    random u give the same output only because neither stores u."""
    torch.manual_seed(0)
    p = P.SNConv2d(3, 4, 3, stride=1, padding=1).eval()
    with torch.no_grad():  # a layer alone starts at zero: its family draws the weights
        p.conv.weight.normal_()
        p.u.normal_()
    x = torch.randn(1, 3, 6, 6)
    w = p.sn_weight()
    mat = p.conv.weight.permute(2, 3, 1, 0).reshape(-1, 4)
    v = p.u @ mat.t()
    v = v * torch.rsqrt((v * v).sum() + 1e-12)
    u = v @ mat
    u = u * torch.rsqrt((u * u).sum() + 1e-12)
    sigma = (v @ mat @ u.t())[0, 0]
    assert torch.allclose(w, p.conv.weight / sigma)
    assert torch.equal(p(x), p(x))


def test_self_attention_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, 5, 16)).astype(np.float32)
    jn = J.SelfAttention()
    v = _np_tree(jn.init(jax.random.PRNGKey(5), jnp.asarray(x)))
    v["params"]["gamma"] = np.array([0.8], np.float32)
    sd = {f"{n}.{k}": t for n in ("conv_f", "conv_g", "conv_h")
          for k, t in (("weight", FJ.conv_weight(v["params"][n]["kernel"])),
                       ("bias", v["params"][n]["bias"]))}
    sd["gamma"] = v["params"]["gamma"]
    p = _load(P.SelfAttention(16), sd)
    _close(p(_nchw(x)).detach().permute(0, 2, 3, 1), jn.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("k,stride,dilation", [(3, 1, 1), (2, 1, 1), (4, 2, 2), (3, 2, 1)])
def test_extract_patches_matches_jax(k, stride, dilation):
    x = np.random.default_rng(6).normal(size=(2, 9, 7, 3)).astype(np.float32)
    want = np.asarray(J._extract_patches(jnp.asarray(x), k, stride, dilation))
    got = P.extract_patches(torch.from_numpy(x), k, stride, dilation).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("cr", [1, 2])
def test_contextual_attention_matches_jax(fuse, cr):
    rng = np.random.default_rng(7)
    fg = rng.normal(size=(2, 12, 12, 4)).astype(np.float32)
    mask = np.zeros((2, 48, 48, 1), np.float32)
    mask[:, 10:30, 14:40] = 1.0
    kw = dict(compression_rate=cr, fuse=fuse)
    want = J.ContextualAttention(**kw).apply({}, jnp.asarray(fg), jnp.asarray(fg),
                                             mask=jnp.asarray(mask))
    got = P.ContextualAttention(**kw)(torch.from_numpy(fg), torch.from_numpy(fg),
                                      torch.from_numpy(mask))
    _close(got, want)
    nomask = P.ContextualAttention(**kw)(torch.from_numpy(fg), torch.from_numpy(fg))
    _close(nomask, J.ContextualAttention(**kw).apply({}, jnp.asarray(fg), jnp.asarray(fg)))


GENERATORS = {
    "sa": (J.SAGatedGenerator, P.SAGatedGenerator, FJ.sa_gated_generator_state_dict_from_jax),
    "ctx": (J.GatedGenerator, P.GatedGenerator, FJ.gated_generator_state_dict_from_jax),
}


@pytest.fixture(scope="module")
def generator_vars():
    """Per (kind, size): JAX variables (gamma non-zero), the train-mode
    output and updated statistics, and the calibrated eval variables."""
    out = {}
    for kind, (jcls, _, _) in GENERATORS.items():
        jn = jcls(lat_channels=4)
        img, mask = _inputs(32)  # the variables do not depend on the size
        v = _np_tree(jn.init(jax.random.PRNGKey(1), jnp.asarray(img), jnp.asarray(mask)))
        if kind == "sa":
            v["params"]["self_attention"]["gamma"] = np.array([0.7], np.float32)
        for size in (32, 64):
            img, mask = _inputs(size)
            (f, c), new = jn.apply(v, jnp.asarray(img), jnp.asarray(mask), train=True,
                                   mutable=["batch_stats"])
            cal = _calibrated(v, new["batch_stats"])
            fe, ce = jn.apply(cal, jnp.asarray(img), jnp.asarray(mask), train=False)
            out[kind, size] = dict(v=v, train=(f, c), new=_np_tree(new["batch_stats"]), cal=cal,
                                   eval=(fe, ce), inputs=(img, mask))
    return out


@pytest.mark.parametrize("kind", sorted(GENERATORS))
@pytest.mark.parametrize("size", [32, 64])
@pytest.mark.parametrize("train", [True, False])
def test_generators_match_jax(generator_vars, kind, size, train):
    g = generator_vars[kind, size]
    _, pcls, conv = GENERATORS[kind]
    img, mask = g["inputs"]
    p = _load(pcls(lat_channels=4), conv(g["v"] if train else g["cal"])).train(train)
    with torch.no_grad():
        fine, coarse = p(torch.from_numpy(img), torch.from_numpy(mask))
    jf, jc = g["train" if train else "eval"]
    assert float(np.std(np.asarray(jf))) > 1e-3  # not a saturated output
    _close(fine, jf)
    _close(coarse, jc)
    if train:
        want = conv({"params": g["v"]["params"], "batch_stats": g["new"]})
        sd = p.state_dict()
        for k, v in want.items():
            if "running" in k:
                _close(sd[k], v, STATS_ATOL)


@pytest.mark.parametrize("train", [True, False])
def test_discriminator_matches_jax(train):
    """Layer 0 at stride 1, BatchNorm on every layer, self-attention + ReLU
    after layer n-2; in train mode the updated u, sigma and BatchNorm
    statistics, in eval mode u unchanged."""
    img, mask = _inputs(64, seed=3)
    jd = J.PatchDiscriminator(out_channels=(8, 16, 16, 16), kernel_size=5)
    v = _np_tree(jd.init(jax.random.PRNGKey(2), jnp.asarray(img), jnp.asarray(mask)))
    v["params"]["self_attention"]["gamma"] = np.array([0.5], np.float32)
    p = _load(P.PatchDiscriminator(out_channels=(8, 16, 16, 16), kernel_size=5),
              FJ.patch_discriminator_state_dict_from_jax(v)).train(train)
    before = {k: t.clone() for k, t in p.state_dict().items()}
    with torch.no_grad():
        out = p(torch.from_numpy(img), torch.from_numpy(mask))
    if train:
        jo, new = jd.apply(v, jnp.asarray(img), jnp.asarray(mask), train=True,
                           mutable=["batch_stats", "spectral_stats"])
        _close(out, jo)
        want = FJ.patch_discriminator_state_dict_from_jax({"params": v["params"], **_np_tree(new)})
        sd = p.state_dict()
        moved = [k for k in want if k.endswith((".u", ".sigma", "running_mean", "running_var"))]
        assert len(moved) == 4 * 4
        for k in moved:
            _close(sd[k], want[k], STATS_ATOL)
    else:
        _close(out, jd.apply(v, jnp.asarray(img), jnp.asarray(mask), train=False))
        assert all(torch.equal(t, before[k]) for k, t in p.state_dict().items())
    assert out.shape == (2, 8, 8, 16)


def _grads_and_stats(net, img, mask):
    net.train()
    out = net(torch.from_numpy(img), torch.from_numpy(mask))
    loss = sum((o * torch.linspace(0.5, 1.5, o.numel()).reshape(o.shape)).sum()
               for o in (out if isinstance(out, tuple) else (out,)))
    loss.backward()
    return ([p.grad.clone() for p in net.parameters()],
            {k: v.clone() for k, v in net.state_dict().items()})


@pytest.mark.parametrize("kind", ["sa", "ctx", "disc"])
def test_remat_gradients_equal_plain(kind):
    """Checkpointed gated convs, attention and SN convs: gradients, the
    BatchNorm statistics and the spectral-norm u torch.equal to the plain
    net's (the recompute replays u and leaves the statistics alone)."""
    img, mask = _inputs(32, seed=5)

    def build(remat):
        torch.manual_seed(11)
        if kind == "disc":
            return P.PatchDiscriminator(out_channels=(8, 16, 16), kernel_size=3, remat=remat)
        cls = P.SAGatedGenerator if kind == "sa" else P.GatedGenerator
        return cls(lat_channels=4, remat=remat)

    g0, s0 = _grads_and_stats(build(False), img, mask)
    g1, s1 = _grads_and_stats(build(True), img, mask)
    assert len(g0) == len(g1) > 0
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert s0.keys() == s1.keys() and all(torch.equal(s0[k], s1[k]) for k in s0)


def test_networks_registry_names():
    g = NETWORKS.build("GatedGenerator", in_channels=2, lat_channels=4, device="cpu",
                       context_attention_kwargs={"fuse": True, "device": "cpu"})
    assert g.refine_attention_enc.attention.fuse
    sa = NETWORKS.build("SAGatedGenerator", lat_channels=4, remat=True)
    assert isinstance(sa, P.SAGatedGenerator) and sa.coarse.remat
    d = NETWORKS.build("PatchDiscriminator", out_channels=[8, 16], sn=False,
                       self_attention=False)
    assert len(d.layer_list) == 2 and not d.layer_list[0].sn
