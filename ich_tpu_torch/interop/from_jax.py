"""Convert the JAX package's U-Net family, ResNet, SN-PatchGAN, autoencoder
and FCDD variables to port ``state_dict``s.

The inverse of ``ich_tpu.interop.torch_port``'s ``port_unet``,
``port_unet_encoder``, ``port_partial_unet`` and ``port_resnet``: flax
variables ``{"params": ..., "batch_stats": ...}`` of
:class:`ich_tpu.models.UNet`, ``UNetEncoder``, ``PartialUNet`` or
``ResNet``, as plain numpy nests, become ``{torch key: numpy array}`` for
their counterparts in :mod:`ich_tpu_torch.models.unet` and
:mod:`ich_tpu_torch.models.resnet`; the generators and the discriminator of
:mod:`ich_tpu.models.inpainting` likewise for
:mod:`ich_tpu_torch.models.inpainting` (with the discriminator's
``spectral_stats`` as the ``u`` and ``sigma`` buffers); ``AENet`` and
``FCDD_CNN_VGG`` for :mod:`ich_tpu_torch.models.ae` and
:mod:`ich_tpu_torch.models.fcdd`. A gated U-Net (``UNet(gated=True)``)
converts as any U-Net: each of its convs emits ``2 ch`` channels, the
features first, in both packages, under the same keys. Layouts converted:

- conv kernels: flax HWIO / DHWIO -> torch OIHW / OIDHW;
- transposed-conv kernels: flax ``(*k, I, O)`` -> torch ``(I, O, *k)``, with
  the spatial axes flipped back (flax's ``ConvTranspose`` correlates, torch
  computes the conv adjoint);
- BatchNorm: ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` ->
  ``weight``/``bias``/``running_mean``/``running_var``; GroupNorm: ``scale``/
  ``bias`` -> ``weight``/``bias``; a net with ``norm="none"`` has no norm
  variables and gets no norm keys;
- Dense kernels: flax ``(I, O)`` -> torch ``(O, I)``.

No JAX import: the inputs are numpy mappings.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

Array = np.ndarray


def conv_weight(kernel: Array) -> Array:
    """flax ``*k I O`` -> torch ``O I *k``."""
    k = np.asarray(kernel)
    nsp = k.ndim - 2
    return np.ascontiguousarray(np.transpose(k, (nsp + 1, nsp) + tuple(range(nsp))))


def convt_weight(kernel: Array) -> Array:
    """flax ConvTranspose ``*k I O`` -> torch ``I O *k``, spatially flipped."""
    k = np.asarray(kernel)
    nsp = k.ndim - 2
    k = np.flip(k, axis=tuple(range(nsp)))
    return np.ascontiguousarray(np.transpose(k, (nsp, nsp + 1) + tuple(range(nsp))))


class _Emitter:
    def __init__(self, variables: Mapping):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats") or {}
        self.sd: Dict[str, Array] = {}

    @staticmethod
    def _get(tree: Mapping, path: str) -> Mapping:
        """The node at a flax path, or {} where there is none."""
        node = tree
        for p in path.split("/"):
            node = node.get(p, {})
        return node

    def conv(self, fpath: str, tname: str, weight=conv_weight) -> None:
        node = self._get(self.params, fpath)
        self.sd[f"{tname}.weight"] = weight(node["kernel"])
        if "bias" in node:
            self.sd[f"{tname}.bias"] = np.asarray(node["bias"])

    def dense(self, fpath: str, tname: str) -> None:
        node = self._get(self.params, fpath)
        self.sd[f"{tname}.weight"] = np.ascontiguousarray(np.asarray(node["kernel"]).T)
        self.sd[f"{tname}.bias"] = np.asarray(node["bias"])

    def norm(self, fpath: str, tname: str) -> None:
        node = self._get(self.params, fpath)
        if not node:  # norm="none": the identity holds no variables
            return
        self.sd[f"{tname}.weight"] = np.asarray(node["scale"])
        self.sd[f"{tname}.bias"] = np.asarray(node["bias"])
        stats = self._get(self.stats, fpath)
        if not stats:  # GroupNorm: no running statistics
            return
        self.sd[f"{tname}.running_mean"] = np.asarray(stats["mean"])
        self.sd[f"{tname}.running_var"] = np.asarray(stats["var"])
        self.sd[f"{tname}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)

    def block(self, fprefix: str, tprefix: str) -> None:
        for i in (1, 2):
            self.conv(f"{fprefix}/conv{i}", f"{tprefix}.conv{i}")
            self.norm(f"{fprefix}/bn{i}/norm", f"{tprefix}.bn{i}")

    def encoder(self) -> None:
        enc = self.params["encoder"]
        for i in range(sum(1 for k in enc if k.startswith("down_"))):
            self.block(f"encoder/down_{i}", f"down_block.{i}")
        self.block("encoder/bottleneck", "bottleneck_block")

    def decoder(self) -> None:
        dec = self.params["decoder"]
        for i in range(sum(1 for k in dec if k.startswith("up_") and "samp" not in k)):
            if f"up_samp_{i}" in dec:
                self.conv(f"decoder/up_samp_{i}/convT", f"up_samp.{i}", weight=convt_weight)
            self.block(f"decoder/up_{i}", f"up_block.{i}")


def unet_state_dict_from_jax(variables: Mapping) -> Dict[str, Array]:
    """JAX ``UNet`` variables -> port ``UNet`` ``state_dict`` (numpy values).
    Depth, 2D/3D and the upsampling kind are read from the variables."""
    e = _Emitter(variables)
    e.encoder()
    e.decoder()
    e.conv("final_conv", "final_conv")
    return e.sd


def ae_state_dict_from_jax(variables: Mapping) -> Dict[str, Array]:
    """JAX ``AENet`` variables -> port ``AENet`` ``state_dict``, either
    decoder: a bilinear decoder's first conv has a 3x3 kernel, the
    transposed-conv decoder's a 2x2 one."""
    e = _Emitter(variables)
    e.conv("encoder/in_conv", "encoder.in_conv.0")
    e.norm("encoder/in_bn", "encoder.in_conv.1")
    enc = e.params["encoder"]
    for i in range(sum(1 for k in enc if k.startswith("conv"))):
        e.conv(f"encoder/conv{i}", f"encoder.conv_list.{i}.0")
        e.norm(f"encoder/bn{i}", f"encoder.conv_list.{i}.1")
    e.conv("encoder/bottleneck_conv", "encoder.bottelneck_conv.0")
    e.norm("encoder/bottleneck_bn", "encoder.bottelneck_conv.1")
    dec = e.params["decoder"]
    bilinear = np.asarray(dec["bottleneck_convT"]["kernel"]).shape[0] == 3
    ci, bi = (1, 2) if bilinear else (0, 1)  # the bilinear upsample sits at 0
    weight = conv_weight if bilinear else convt_weight
    e.conv("decoder/bottleneck_convT", f"decoder.bottelneck_conv.{ci}", weight=weight)
    e.norm("decoder/bottleneck_bn", f"decoder.bottelneck_conv.{bi}")
    for i in range(sum(1 for k in dec if k.startswith("convT"))):
        e.conv(f"decoder/convT{i}", f"decoder.conv_list.{i}.{ci}", weight=weight)
        e.norm(f"decoder/bn{i}", f"decoder.conv_list.{i}.{bi}")
    e.conv("decoder/out_conv", "decoder.out_conv.0")
    e.norm("decoder/out_bn", "decoder.out_conv.1")
    return e.sd


# FCDD_CNN_VGG's (conv, BatchNorm) pairs in the reference's ``features``
# Sequential (ReLU and max-pool layers hold no parameters)
_FCDD_CONV_IDX = (0, 4, 8, 11, 15, 18)


def fcdd_state_dict_from_jax(variables: Mapping) -> Dict[str, Array]:
    """JAX ``FCDD_CNN_VGG`` variables -> port ``FCDD_CNN_VGG``
    ``state_dict``."""
    e = _Emitter(variables)
    for i, idx in enumerate(_FCDD_CONV_IDX):
        e.conv(f"conv{i}", f"features.{idx}")
        e.norm(f"bn{i}", f"features.{idx + 1}")
    e.conv("conv_final", "conv_final")
    return e.sd


def unet_encoder_state_dict_from_jax(variables: Mapping) -> Dict[str, Array]:
    """JAX ``UNetEncoder`` variables -> port ``UNetEncoder`` ``state_dict``."""
    e = _Emitter(variables)
    e.encoder()
    head = e.params["mlp_head"]
    for i in range(len(head)):
        e.dense(f"mlp_head/fc{i}", f"mlp_head.fc_layers.{i}")
    return e.sd


def resnet_state_dict_from_jax(variables: Mapping) -> Dict[str, Array]:
    """JAX ``ResNet`` variables -> port ``ResNet`` ``state_dict``: the stem,
    every ``stage{s}_block{b}`` (two convs for a basic block, three for a
    bottleneck, and the downsample branch where there is one) and ``fc``."""
    e = _Emitter(variables)
    e.conv("stem_conv", "conv1")
    e.norm("stem_bn", "bn1")
    blocks = sorted((tuple(int(n) for n in k[len("stage"):].split("_block")), k)
                    for k in e.params if k.startswith("stage"))
    for (s, b), fname in blocks:
        t = f"layer{s + 1}.{b}"
        for i in (1, 2, 3):
            if f"conv{i}" in e.params[fname]:
                e.conv(f"{fname}/conv{i}", f"{t}.conv{i}")
                e.norm(f"{fname}/bn{i}", f"{t}.bn{i}")
        if "down_conv" in e.params[fname]:
            e.conv(f"{fname}/down_conv", f"{t}.shortcut.0")
            e.norm(f"{fname}/down_bn", f"{t}.shortcut.1")
    e.dense("fc", "linear")
    return e.sd


def partial_unet_state_dict_from_jax(variables: Mapping) -> Dict[str, Array]:
    """JAX ``PartialUNet`` variables -> port ``PartialUNet`` ``state_dict``."""
    e = _Emitter(variables)
    e.encoder()
    e.decoder()
    head = e.params["conv_head"]
    for i in range(len(head)):
        e.conv(f"conv_head/conv{i}", f"final_conv.conv_layers.{i}")
    return e.sd


# -- SN-PatchGAN networks ----------------------------------------------------------


def _flat(tree: Mapping, prefix: str = "") -> Dict[str, Array]:
    """A nested mapping as {"a/b/c": leaf}; flax's spectral-norm keys, which
    hold slashes themselves ("conv/kernel/u"), come out the same."""
    out = {}
    for k, v in (tree or {}).items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


class _GanEmitter(_Emitter):
    def gated(self, fpath: str, tname: str) -> None:
        """A ``GatedConv2d`` (its fused 2F conv and the feature half's
        BatchNorm) or an ``UpsampleGatedConv2d`` (the same under ``gconv``
        / ``gated_conv``)."""
        if "gconv" in self._get(self.params, fpath):
            fpath, tname = f"{fpath}/gconv", f"{tname}.gated_conv"
        self.conv(f"{fpath}/conv", f"{tname}.conv")
        self.norm(f"{fpath}/norm", f"{tname}.norm")

    def stack(self, fprefix: str, tprefix: str) -> None:
        for i in range(sum(1 for k in self._get(self.params, fprefix) if k.startswith("g"))):
            self.gated(f"{fprefix}/g{i}", f"{tprefix}.{i}")

    def self_attention(self, fpath: str, tname: str) -> None:
        for name in ("conv_f", "conv_g", "conv_h"):
            self.conv(f"{fpath}/{name}", f"{tname}.{name}")
        self.sd[f"{tname}.gamma"] = np.asarray(self._get(self.params, fpath)["gamma"])


def gated_generator_state_dict_from_jax(variables: Mapping) -> Dict[str, Array]:
    """JAX ``GatedGenerator`` variables (``params``, ``batch_stats``) -> port
    ``GatedGenerator`` ``state_dict``; the contextual branch is converted
    when the variables hold it."""
    e = _GanEmitter(variables)
    e.stack("coarse", "coarse")
    e.stack("refine_enc", "refine_enc")
    if "refine_attn_cnn1" in e.params:
        e.stack("refine_attn_cnn1", "refine_attention_enc.cnn1")
        e.stack("refine_attn_cnn2", "refine_attention_enc.cnn2")
    e.stack("refine_dec", "refine_dec")
    return e.sd


def sa_gated_generator_state_dict_from_jax(variables: Mapping) -> Dict[str, Array]:
    """JAX ``SAGatedGenerator`` variables -> port ``SAGatedGenerator``
    ``state_dict`` (the attention under ``refine_attention.0``)."""
    e = _GanEmitter(variables)
    e.stack("coarse", "coarse")
    e.stack("refine_enc", "refine_enc")
    e.self_attention("self_attention", "refine_attention.0")
    e.stack("refine_dec", "refine_dec")
    return e.sd


def patch_discriminator_state_dict_from_jax(variables: Mapping) -> Dict[str, Array]:
    """JAX ``PatchDiscriminator`` variables (``params``, ``batch_stats``,
    ``spectral_stats``) -> port ``PatchDiscriminator`` ``state_dict``, each
    spectral-norm layer's ``u`` and ``sigma`` included. With
    self-attention the last conv sits at ``layer_list.{n + 1}``, after the
    attention and its ReLU."""
    e = _GanEmitter(variables)
    n = sum(1 for k in e.params if k.startswith("conv"))
    attn = "self_attention" in e.params
    spectral = _flat(variables.get("spectral_stats") or {})
    for i in range(n):
        t = f"layer_list.{i + 2 if attn and i == n - 1 else i}"
        e.conv(f"conv{i}/conv", f"{t}.conv")
        e.norm(f"conv{i}/norm", f"{t}.norm")
        for name in ("u", "sigma"):
            key = f"conv{i}/SpectralNorm_0/conv/kernel/{name}"
            if key in spectral:
                e.sd[f"{t}.{name}"] = spectral[key]
    if attn:
        e.self_attention("self_attention", f"layer_list.{n - 1}")
    return e.sd
