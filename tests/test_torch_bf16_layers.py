"""The port's layers at ``compute_dtype=bfloat16`` against the JAX
package's flax modules at ``dtype=bfloat16``.

Same weights (flax init, perturbed, carried across by ``convert.py``),
same numpy inputs, on the CPU. Both sides round to bf16 at the same
places (``models/layers.py``); between roundings they sum f32 in other
orders, so a bf16 output may land one bf16 step (ulp) away where the f32
value sits near a rounding boundary. Tolerances:

- a single layer's bf16 output: within 1 bf16 ulp of JAX's, elementwise;
- gradients of a single layer (bf16-rounded, as JAX rounds them): within
  1 bf16 ulp, or atol 1e-6 of the leaf's scale where the value is tiny;
- a whole backbone or decoder, where a one-ulp flip early moves later
  layers: rtol 1e-2 with atol 1e-2 of the output's largest magnitude,
  and the bf16 output at least ten times closer to JAX's bf16 output than
  to the port's own f32 output (the bf16 path is really taken).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu.models import CGEncoder as FlaxCGEncoder
from opensetgaitrecognition_pcaa_tpu.models import ORCEDEncoder as FlaxORCEDEncoder
from opensetgaitrecognition_pcaa_tpu.models.layers import (
    CausalDilatedConv1d as FlaxConv,
    TorchDense as FlaxDense,
)
from opensetgaitrecognition_pcaa_tpu.models.norm import TorchBatchNorm as FlaxBatchNorm
from opensetgaitrecognition_pcaa_tpu.models.pcaa import CGDecoder as FlaxCGDecoder

from opensetgaitrecognition_pcaa_tpu_torch.convert import decoder_state_dict, encoder_state_dict
from opensetgaitrecognition_pcaa_tpu_torch.models.layers import (
    CausalDilatedConv1d,
    TorchDense,
)
from opensetgaitrecognition_pcaa_tpu_torch.models.norm import TorchBatchNorm
from opensetgaitrecognition_pcaa_tpu_torch.models.orced import ORCEDEncoder
from opensetgaitrecognition_pcaa_tpu_torch.models.pcaa import CGDecoder, CGEncoder

BF16 = torch.bfloat16
SMALL = dict(sup_latent_dim=8, pointnet_out_dim=16, dtc_filters=(4, 4, 4, 4, 4, 8))

torch.set_num_threads(1)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |x| (8 significant bits)."""
    a = np.maximum(np.abs(np.asarray(x, np.float64)), 2.0**-126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def assert_within_ulps(got, want, ulps=1.0, atol=0.0, what=""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    bad = np.abs(got - want) > ulps * bf16_ulp(want) + atol
    assert not bad.any(), (what, int(bad.sum()), bad.size,
                           float(np.abs(got - want)[bad].max()))


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a, jnp.float32))


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)


def test_dense_forward_and_vjp():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(6, 20)).astype(np.float32)
    g_out = rng.normal(size=(6, 12)).astype(np.float32)
    flax_dense = FlaxDense(12, dtype=jnp.bfloat16)
    params = _perturbed(flax_dense.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)

    def f(x, p):
        return flax_dense.apply({"params": p}, x)

    want, vjp = jax.vjp(f, jnp.asarray(x), params)
    assert want.dtype == jnp.bfloat16
    want_gx, want_gp = vjp(jnp.asarray(g_out).astype(jnp.bfloat16))

    dense = TorchDense(20, 12, compute_dtype=BF16)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(params["kernel"].T.copy()))
        dense.bias.copy_(torch.from_numpy(params["bias"]))
    xt = torch.from_numpy(x).requires_grad_()
    got = dense(xt)
    assert got.dtype == BF16
    assert_within_ulps(got.float().detach().numpy(), _np(want), what="y")
    got.backward(torch.from_numpy(g_out).to(BF16))
    assert_within_ulps(xt.grad.numpy(), _np(want_gx), what="g_x")
    assert_within_ulps(dense.weight.grad.numpy().T, _np(want_gp["kernel"]), what="g_kernel")
    np.testing.assert_allclose(dense.bias.grad.numpy(), _np(want_gp["bias"]), rtol=1e-6,
                               atol=1e-6)
    # the f32 bias is added to the f32 sum before the rounding
    xb = torch.from_numpy(x).to(BF16).float()
    wb = dense.weight.detach().to(BF16).float()
    exact = (xb @ wb.T + dense.bias.detach()).to(BF16)
    assert torch.equal(dense(torch.from_numpy(x)).detach(), exact)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_conv_block(train):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 12, 10)).astype(np.float32)
    conv = FlaxConv(features=6, dilation=2, dtype=jnp.bfloat16)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    params = _perturbed(v["params"], 3)
    stats = {"TorchBatchNorm_0": {"mean": rng.normal(size=6).astype(np.float32) * 0.1,
                                  "var": rng.uniform(0.5, 2, 6).astype(np.float32)}}
    want, muts = conv.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                            train=train, mutable=["batch_stats"])
    assert want.dtype == jnp.bfloat16

    port = CausalDilatedConv1d(10, 6, 2, compute_dtype=BF16)
    with torch.no_grad():
        port.conv.weight.copy_(torch.from_numpy(params["Conv_0"]["kernel"].transpose(2, 1, 0).copy()))
        port.conv.bias.copy_(torch.from_numpy(params["Conv_0"]["bias"]))
        port.norm.scale.copy_(torch.from_numpy(params["TorchBatchNorm_0"]["scale"]))
        port.norm.bias.copy_(torch.from_numpy(params["TorchBatchNorm_0"]["bias"]))
        port.norm.mean.copy_(torch.from_numpy(stats["TorchBatchNorm_0"]["mean"]))
        port.norm.var.copy_(torch.from_numpy(stats["TorchBatchNorm_0"]["var"]))
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == BF16
    # BatchNorm normalizes the bf16 conv output: a one-ulp flip there moves
    # the output by about one ulp of the normalized value
    assert_within_ulps(got.float().numpy(), _np(want), ulps=2, what="conv block")
    new = muts["batch_stats"]["TorchBatchNorm_0"]
    np.testing.assert_allclose(port.norm.mean.numpy(), _np(new["mean"]), rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(port.norm.var.numpy(), _np(new["var"]), rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_batchnorm_keeps_bf16(train):
    rng = np.random.default_rng(4)
    x = rng.normal(1.5, 2.0, size=(3, 5, 7, 6)).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    params = {"scale": rng.uniform(0.5, 2, 6).astype(np.float32),
              "bias": rng.normal(size=6).astype(np.float32)}
    stats = {"mean": rng.normal(size=6).astype(np.float32),
             "var": rng.uniform(0.5, 2, 6).astype(np.float32)}
    want, muts = FlaxBatchNorm().apply({"params": params, "batch_stats": stats}, xb,
                                       use_running_average=not train, mutable=["batch_stats"])
    bn = TorchBatchNorm(6)
    with torch.no_grad():
        for k in ("scale", "bias"):
            getattr(bn, k).copy_(torch.from_numpy(params[k]))
        for k in ("mean", "var"):
            getattr(bn, k).copy_(torch.from_numpy(stats[k]))
    bn.train(train)
    got = bn(torch.from_numpy(x).to(BF16))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert_within_ulps(got.float().detach().numpy(), _np(want), what="bn")
    assert bn.mean.dtype == torch.float32
    new = muts["batch_stats"]
    np.testing.assert_allclose(bn.mean.numpy(), _np(new["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), _np(new["var"]), rtol=1e-6, atol=1e-6)


def _encoder_pair(kind, x, seed=0):
    if kind == "pcaa":
        flax_f32 = FlaxCGEncoder(n_out_labels=3, use_projection_head=True, **SMALL)
        flax_bf16 = FlaxCGEncoder(n_out_labels=3, use_projection_head=True,
                                  dtype=jnp.bfloat16, **SMALL)
        make = lambda dtype: CGEncoder(3, in_features=4, use_projection_head=True,
                                       compute_dtype=dtype, **SMALL)
        init = dict(rngs=jax.random.PRNGKey(seed))
    else:
        flax_f32 = FlaxORCEDEncoder(n_out_labels=3, **SMALL)
        flax_bf16 = FlaxORCEDEncoder(n_out_labels=3, dtype=jnp.bfloat16, **SMALL)
        make = lambda dtype: ORCEDEncoder(3, in_features=4, compute_dtype=dtype, **SMALL)
        init = dict(rngs={"params": jax.random.PRNGKey(seed),
                          "reparam": jax.random.PRNGKey(seed)})
    v = flax_f32.init(init["rngs"], jnp.asarray(x), train=False)
    variables = {"params": _perturbed(v["params"], seed + 1),
                 "batch_stats": jax.device_get(v["batch_stats"])}
    ports = {}
    for dtype in (torch.float32, BF16):
        enc = make(dtype)
        enc.load_state_dict(encoder_state_dict(variables))
        ports[dtype] = enc
    return flax_bf16, variables, ports


@pytest.mark.parametrize("kind", ["pcaa", "orced"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_encoder_forward(kind, train):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 6, 12, 4)).astype(np.float32)
    eps = rng.normal(size=(4, 8)).astype(np.float32)
    flax_bf16, variables, ports = _encoder_pair(kind, x)
    kw = {"eps": jnp.asarray(eps)} if kind == "orced" else {}
    out = flax_bf16.apply(variables, jnp.asarray(x), train=train, mutable=["batch_stats"], **kw)
    want = jax.device_get(out[0])
    got = {}
    for dtype, enc in ports.items():
        enc.train(train)
        with torch.no_grad():
            res = enc(torch.from_numpy(x), **({"eps": torch.from_numpy(eps)}
                                              if kind == "orced" else {}))
        got[dtype] = [r.numpy() for r in res]
    for g, g32, w in zip(got[BF16], got[torch.float32], want):
        w = np.asarray(w)
        assert g.dtype == np.float32  # the heads compute in f32
        atol = 1e-2 * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=1e-2, atol=atol)
        d_jax, d_f32 = np.abs(g - w).max(), np.abs(g - g32).max()
        assert d_f32 > 0 and d_jax * 10 <= d_f32, (d_jax, d_f32)
    if train:
        want_stats = jax.tree_util.tree_leaves(out[1]["batch_stats"])
        enc = ports[BF16]
        got_stats = [b.numpy() for n, b in sorted(enc.named_buffers())]
        assert len(got_stats) == len(want_stats)


def test_decoder_forward_and_vjp():
    rng = np.random.default_rng(6)
    z = rng.normal(size=(3, 8)).astype(np.float32)
    g_out = rng.normal(size=(3, 6, 10, 4)).astype(np.float32)
    flax_dec = FlaxCGDecoder(nsteps=6, nmax_points=10, nfeatures=4, dtype=jnp.bfloat16)
    params = _perturbed(flax_dec.init(jax.random.PRNGKey(0), jnp.asarray(z))["params"], 7)

    def f(z, p):
        return flax_dec.apply({"params": p}, z)

    want, vjp = jax.vjp(f, jnp.asarray(z), params)
    assert want.dtype == jnp.float32
    want_gz, _ = vjp(jnp.asarray(g_out))
    outs = {}
    for dtype in (torch.float32, BF16):
        dec = CGDecoder(8, 6, 10, 4, compute_dtype=dtype)
        dec.load_state_dict(decoder_state_dict({"params": params}))
        zt = torch.from_numpy(z).requires_grad_()
        y = dec(zt)
        assert y.dtype == torch.float32
        y.backward(torch.from_numpy(g_out))
        outs[dtype] = (y.detach().numpy(), zt.grad.numpy())
    y, gz = outs[BF16]
    # the reconstruction is the last layer's bf16 output, upcast
    assert np.array_equal(y, torch.from_numpy(y).to(BF16).float().numpy())
    for got, got32, w in ((y, outs[torch.float32][0], _np(want)),
                          (gz, outs[torch.float32][1], _np(want_gz))):
        np.testing.assert_allclose(got, w, rtol=1e-2, atol=1e-2 * float(np.abs(w).max()))
        assert np.abs(got - w).max() * 10 <= np.abs(got - got32).max()
