"""Torch state_dict import (``training/import_torch.py``) against the JAX
package's: the same torch tensors through JAX's ``import_state_dict`` /
``import_by_order`` and then ``weights.from_jax_params`` give the port's
``import_state_dict`` / ``import_by_order`` results exactly, at a tiny
two_stage + warp_features config (whose raw upsample leaves flax's
``flatten_params`` does not visit)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from video_super_resolution_tpu.training import import_torch as jimp

from video_super_resolution_tpu_torch.config import ModelConfig
from video_super_resolution_tpu_torch.models.common import init_params
from video_super_resolution_tpu_torch.models.vsr import VSRModel
from video_super_resolution_tpu_torch.training import import_torch as pimp
from video_super_resolution_tpu_torch.weights import from_jax_params, to_jax_params
import torch_workers  # noqa: F401  caps torch's threads per xdist worker

TINY = dict(pyramid_channels=(8, 16), flow_estimator_channels=(16, 16),
            context_channels=(16, 16), depth_channels=8, depth_levels=4,
            fusion_channels=16, sr_channels=16, sr_blocks=2,
            sr_head_style="two_stage", warp_features=True)


@pytest.fixture(scope="module")
def model():
    return init_params(VSRModel(ModelConfig(**TINY)),
                       torch.Generator().manual_seed(0))


def assert_same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_import_by_order_matches_jax(model):
    """Tensors zipped in flax's sorted-path order (ConvLReLU_10 before
    ConvLReLU_2) land on the same parameters in both packages; the
    two_stage head's upsample parameters keep their values in both."""
    params = to_jax_params(model.state_dict())
    rng = np.random.default_rng(1)
    tensors = []
    for path, leaf in jimp.flatten_params(params):
        k = leaf["kernel"]
        tensors.append((torch.from_numpy(rng.standard_normal(
            (k.shape[3], k.shape[2], k.shape[0], k.shape[1])).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(k.shape[3]).astype(np.float32))))
    want = from_jax_params(jimp.import_by_order(tensors, params), model)
    got = pimp.import_by_order(tensors, model)
    assert_same(got, want)
    paths = pimp.conv_modules_in_flax_order(model)
    assert len(paths) == len(tensors) and "sr_head.upsample_0" not in paths
    assert (paths.index("depth_net.ConvLReLU_10")
            < paths.index("depth_net.ConvLReLU_2"))
    for u in (0, 1):
        key = f"sr_head.upsample_{u}.weight"
        assert torch.equal(got[key], model.state_dict()[key])
    with pytest.raises(ValueError, match="torch modules"):
        pimp.import_by_order(tensors[1:], model)


def test_import_state_dict_matches_jax(model):
    """A torch checkpoint with its own module names, mapped by prefix: a
    conv with and without a bias, onto the two_stage head's Conv_1 and the
    fusion's first conv."""
    rng = np.random.default_rng(2)
    sd = {"net.out.weight": rng.standard_normal((3, 16, 3, 3)),
          "net.out.bias": rng.standard_normal(3),
          "net.fuse.weight": rng.standard_normal((16, 33, 3, 3))}
    sd = {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}
    params = to_jax_params(model.state_dict())
    jparams = jimp.import_state_dict(
        sd, {"net.out": ("sr_head", "Conv_1"),
             "net.fuse": ("fusion", "ConvLReLU_0")}, params)
    want = from_jax_params(jparams, model)
    got = pimp.import_state_dict(
        sd, {"net.out": "sr_head.Conv_1", "net.fuse": "fusion.ConvLReLU_0"},
        model)
    assert_same(got, want)
    assert torch.equal(got["sr_head.Conv_1.bias"], sd["net.out.bias"])
    model2 = VSRModel(ModelConfig(**TINY))
    model2.load_state_dict(got, strict=True)
    with pytest.raises(ValueError, match="shape"):
        pimp.import_state_dict(sd, {"net.out": "fusion.ConvLReLU_0"}, model)
    with pytest.raises(ValueError, match="no parameter"):
        pimp.import_state_dict(sd, {"net.out": "sr_head.Conv_9"}, model)


def test_conv_transpose_kernel_matches_jax():
    w = np.random.default_rng(3).standard_normal((4, 6, 3, 3)).astype(np.float32)
    want = jimp.conv_transpose_kernel_to_hwio(w).transpose(3, 2, 0, 1)
    got = pimp.conv_transpose_kernel_to_oihw(torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    # the flipped kernel's correlation is the transposed conv's output
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 4, 7, 9)).astype(np.float32))
    tconv = torch.nn.functional.conv_transpose2d(x, torch.from_numpy(w), padding=1)
    conv = torch.nn.functional.conv2d(x, got, padding=1)
    torch.testing.assert_close(conv, tconv, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wrapped", [False, True])
def test_load_torch_checkpoint(tmp_path, wrapped):
    sd = {"a.weight": torch.randn(2, 3, 3, 3), "a.bias": torch.randn(2)}
    path = str(tmp_path / "w.pt")
    torch.save({"state_dict": sd} if wrapped else sd, path)
    got = pimp.load_torch_checkpoint(path)
    want = jimp.load_torch_checkpoint(path)
    assert got.keys() == want.keys() == sd.keys()
    for k in sd:
        assert torch.equal(got[k], sd[k])
        np.testing.assert_array_equal(got[k].numpy(), want[k])
