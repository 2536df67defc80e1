"""Convert the JAX package's U-Net variables to a port ``state_dict``.

The inverse of ``ich_tpu.interop.torch_port.port_unet``: flax variables
``{"params": ..., "batch_stats": ...}`` of :class:`ich_tpu.models.UNet`, as
plain numpy nests, become ``{torch key: numpy array}`` for
:class:`ich_tpu_torch.models.unet.UNet`. Layouts converted:

- conv kernels: flax HWIO / DHWIO -> torch OIHW / OIDHW;
- transposed-conv kernels: flax ``(*k, I, O)`` -> torch ``(I, O, *k)``, with
  the spatial axes flipped back (flax's ``ConvTranspose`` correlates, torch
  computes the conv adjoint);
- BatchNorm: ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` ->
  ``weight``/``bias``/``running_mean``/``running_var``; GroupNorm: ``scale``/
  ``bias`` -> ``weight``/``bias``.

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

    def norm(self, fpath: str, tname: str) -> None:
        node = self._get(self.params, fpath)
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


def unet_state_dict_from_jax(variables: Mapping) -> Dict[str, Array]:
    """JAX ``UNet`` variables -> port ``UNet`` ``state_dict`` (numpy values).
    Depth, 2D/3D and the upsampling kind are read from the variables."""
    e = _Emitter(variables)
    enc = e.params["encoder"]
    n_down = sum(1 for k in enc if k.startswith("down_"))
    for i in range(n_down):
        e.block(f"encoder/down_{i}", f"down_block.{i}")
    e.block("encoder/bottleneck", "bottleneck_block")
    dec = e.params["decoder"]
    for i in range(n_down):
        if f"up_samp_{i}" in dec:
            e.conv(f"decoder/up_samp_{i}/convT", f"up_samp.{i}", weight=convt_weight)
        e.block(f"decoder/up_{i}", f"up_block.{i}")
    e.conv("final_conv", "final_conv")
    return e.sd
