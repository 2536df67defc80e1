"""scripts/jax_to_torch_model.py: a model saved by ich_tpu's UNet2D serves
the same masks from ich_tpu_torch's UNet2D after conversion."""

import os
import sys

import jax
import numpy as np
import torch

from ich_tpu.data import synthetic_ich_volume
from ich_tpu.interop.torch_port import port_unet
from ich_tpu.models import UNet as JaxUNet
from ich_tpu.train.segmentation2d import UNet2D as JaxUNet2D
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.train.segmentation2d import UNet2D

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import jax_to_torch_model  # noqa: E402

torch.set_num_threads(2)


def test_converted_model_serves_the_same_masks(tmp_path, capsys):
    jt = JaxUNet2D(JaxUNet(depth=2, top_filter=4, p_dropout=0.0), batch_size=4)
    jt._ensure_state((16, 16))
    jax_fn, torch_fn = str(tmp_path / "model.bin"), str(tmp_path / "out" / "model.pt")
    jt.save_model(jax_fn)

    jax_to_torch_model.main([jax_fn, torch_fn])
    assert "model.pt" in capsys.readouterr().out

    pt = UNet2D(UNet(depth=2, top_filter=4, p_dropout=0.0), batch_size=4, device="cpu")
    pt.load_model(torch_fn)  # strict load: every key present, none extra
    back = port_unet({k: t.numpy() for k, t in pt.get_state_dict().items()})
    want = jax.tree_util.tree_map(np.asarray, jt.get_state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, b)
    vol = synthetic_ich_volume(size=16, depth=5, seed=0)[0]
    kw = dict(window=(50.0, 200.0), input_size=(16, 16), return_pred=True)
    assert np.mean(pt.segment_volume(vol, **kw) == jt.segment_volume(vol, **kw)) >= 0.999
