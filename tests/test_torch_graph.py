"""The port's folded graph (``yolofastest_torch.models``) against the JAX
package's, on the CPU: the BN fold bit for bit, the folded forward on the
same weights and inputs, and the golden reference logits."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._jax_refs import jax_refs, register  # noqa: F401 (jax_refs: a fixture)
from yolofastest_torch.models import (Executor, FoldedExecutor, fold_batchnorm,
                                      folded_apply, load_variables,
                                      torch_params_from_folded, walk_topology, zoo_path)
from yolofastest_torch.utils.device import exact_fp32
from yolofastest_tpu.models import graph as jgraph
from yolofastest_tpu.models import zoo as jzoo

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "weights")
FP_ZOO = ["yolofastest_256x320", "yolofastest_512x640", "yolofastest_lite_256x320",
          "yolofastest_lite_512x640", "yolofastest_pruned040_256x320"]


@pytest.fixture(scope="module")
def zoo256():
    variables = load_variables(zoo_path("256x320"))
    folded = fold_batchnorm(variables)
    return variables, folded, torch_params_from_folded(folded, "cpu")


@pytest.mark.parametrize("name", FP_ZOO)
def test_fold_batchnorm_bitwise(name):
    path = os.path.join(WEIGHTS, f"{name}.npz")
    ours = fold_batchnorm(load_variables(path))
    theirs = jgraph.fold_batchnorm(jzoo.load_variables(path))
    assert ours.keys() == theirs.keys()
    for layer in theirs:
        for leaf in ("kernel", "bias"):
            a, b = ours[layer][leaf], theirs[layer][leaf]
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_zoo_round_trip(tmp_path, zoo256):
    from yolofastest_torch.models import save_variables

    variables = zoo256[0]
    p = str(tmp_path / "zoo.npz")
    save_variables(variables, p)
    back = jzoo.load_variables(p)
    assert jax.tree.structure(back) == jax.tree.structure(variables)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(variables)):
        np.testing.assert_array_equal(a, b)


def _random_inputs():
    return np.random.default_rng(0).uniform(-0.5, 0.5, (2, 64, 96, 1)).astype(np.float32)


def _jax_folded_apply():
    """The JAX folded forward of the 256x320 zoo on :func:`_random_inputs`,
    jitted, in a worker of tests/_jax_refs.py."""
    folded = fold_batchnorm(load_variables(zoo_path("256x320")))
    out = jax.jit(jgraph.folded_apply)(jax.tree.map(jnp.asarray, folded),
                                       jnp.asarray(_random_inputs()))
    return jax.tree.map(np.asarray, out)


register("graph/folded_apply", _jax_folded_apply)


def test_folded_apply_matches_jax(zoo256, jax_refs):  # noqa: F811
    """Real 256x320 weights on random 64x96 inputs; fp32 on both sides, sums
    in another order: atol 1e-4."""
    _, folded, params = zoo256
    ours = folded_apply(params, torch.from_numpy(_random_inputs()))
    theirs = jax_refs["graph/folded_apply"]
    for o, t in zip(ours, theirs):
        assert tuple(o.shape) == t.shape
        np.testing.assert_allclose(o.numpy(), np.asarray(t), atol=1e-4)


def test_folded_apply_matches_golden_logits(zoo256):
    """The reference torch model's logits on the 4 fixture frames (NCHW):
    BN folding costs < 1e-3, the bound of tests/test_export_torch.py:103-104."""
    params = zoo256[2]
    fx = np.load(os.path.join(FIXTURES, "golden_256x320.npz"))
    x = (fx["pre_imgs"][:4].astype(np.float32)[..., None] - 128.0) / 255.0
    large, small = folded_apply(params, torch.from_numpy(x))
    np.testing.assert_allclose(large.permute(0, 3, 1, 2).numpy(), fx["logits_large"], atol=2e-3)
    np.testing.assert_allclose(small.permute(0, 3, 1, 2).numpy(), fx["logits_small"], atol=2e-3)


class _BlockByBlock(FoldedExecutor):
    res_chain = Executor.res_chain


def test_chains_equal_block_by_block(zoo256):
    """The chain path (one fused call per chain) equals the base executor's
    block-by-block res path (separate convs); fp32, summation order only."""
    params = zoo256[2]
    x = torch.from_numpy(np.random.default_rng(1).uniform(
        -0.5, 0.5, (2, 64, 96, 1)).astype(np.float32))
    fused = folded_apply(params, x)
    with exact_fp32():
        plain = walk_topology(x, _BlockByBlock(params))
    for f, p in zip(fused, plain):
        np.testing.assert_allclose(f.numpy(), p.numpy(), atol=1e-5)


def test_bf16_forward(zoo256):
    """bf16 params and compute: finite heads of the right dtype, within bf16
    distance (8 significant bits, rounded after every layer) of fp32."""
    folded = zoo256[1]
    params = torch_params_from_folded(folded, "cpu", torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -0.5, 0.5, (1, 64, 96, 1)).astype(np.float32))
    ours = folded_apply(params, x, torch.bfloat16)
    ref = folded_apply(zoo256[2], x)
    for o, r in zip(ours, ref):
        assert o.dtype == torch.bfloat16 and torch.isfinite(o.float()).all()
        scale = r.abs().max().item()
        assert (o.float() - r).abs().max().item() < 0.1 * scale


def test_params_layout(zoo256):
    folded, params = zoo256[1], zoo256[2]
    conv = params["layers"]["conv0"]["weight"]
    assert tuple(conv.shape) == (8, 1, 3, 3)
    assert conv.is_contiguous(memory_format=torch.channels_last)
    dw = params["layers"]["conv1_3"]["weight"]
    assert tuple(dw.shape) == (8, 1, 3, 3)
    np.testing.assert_array_equal(dw[:, 0].numpy(), folded["conv1_3"]["kernel"][:, :, 0].transpose(2, 0, 1))
    de = params["layers"]["deconv5_1"]["weight"]
    assert tuple(de.shape) == folded["deconv5_1"]["kernel"].shape[2:] + (2, 2)
    w1, b1, w2, b2, w3, b3 = params["chains"][("res5_1", "res5_2", "res5_3", "res5_4", "res5_5")]
    assert tuple(w1.shape) == (5, 48, 224) and b1.dtype == torch.float32


def test_no_device_raises_without_card(monkeypatch, zoo256):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_params_from_folded(zoo256[1])
