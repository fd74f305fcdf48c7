"""The zero padding by which the CUDA kernels take every shape the JAX
kernel wrappers take is exact: on the CPU, each plain version on the
padded operands, sliced back to the real widths, equals it on the
unpadded ones bit for bit. (The kernels themselves are held against these
plain versions on the card, ``tests/test_torch_kernels_gpu.py``.)

- PointNet + pool, inference: C, H = D // 2 and D to multiples of 4;
- the train layer: C_in and C_out to multiples of 4, the affine with mean,
  scale and shift 0;
- Chamfer: C to 4 (fewer channels) or 8 (6 or 7), both clouds alike.

At some widths the CPU's own matrix product blocks a padded K otherwise
than the unpadded one (K = 15 → 16 at N = 32, K = 6 → 8), so its sums
reassociate and the plain version is not bit-stable under padding there;
those widths (D = 30, C_out = 30, C = 6) are held against the plain
version on the card only. The kernels add the padded terms as exact zeros.
"""

import numpy as np
import pytest
import torch

from opensetgaitrecognition_pcaa_tpu_torch.ops import chamfer_kernel as ck
from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_infer as pn
from opensetgaitrecognition_pcaa_tpu_torch.ops import pointnet_train as pt
from opensetgaitrecognition_pcaa_tpu_torch.ops.chamfer import frame_chamfer


def _folded(rng, c, d):
    h = d // 2
    out = {}
    for i, (a, b) in enumerate([(c, h), (h, h), (h, d), (d, d)], start=1):
        out[f"w{i}"] = torch.from_numpy((rng.uniform(-1, 1, (a, b)) / np.sqrt(a)).astype(np.float32))
        out[f"b{i}"] = torch.from_numpy((rng.uniform(-1, 1, b) / np.sqrt(a)).astype(np.float32))
    return out


@pytest.mark.parametrize("c,d", [(4, 32), (3, 32), (5, 200), (12, 200), (3, 201), (5, 64)],
                         ids=["c4_d32", "c3_d32", "c5_d200", "c12_d200", "c3_d201", "c5_d64"])
def test_pointnet_infer_padding_is_exact(c, d):
    rng = np.random.default_rng(c * 1000 + d)
    x = torch.from_numpy(rng.normal(size=(2, 3, 37, c)).astype(np.float32))
    folded = _folded(rng, c, d)
    xp, fp = pn.pad_widths(x, folded)
    h = d // 2
    widths = (xp.shape[3], fp["w1"].shape[1], fp["w4"].shape[1])
    assert widths == tuple(-(-w // 4) * 4 for w in (c, h, d))
    got = pn.pointnet_pool_ref(xp, fp)
    assert not got[..., d:].any()  # a padded width is ELU(0) = 0
    assert torch.equal(got[..., :d], pn.pointnet_pool_ref(x, folded))


@pytest.mark.parametrize("c_in,c_out,with_affine",
                         [(5, 8, False), (5, 512, False), (8, 15, True), (15, 15, True)],
                         ids=["nfeatures5", "nfeatures5_w512", "out15", "in15_out15"])
def test_train_layer_padding_is_exact(c_in, c_out, with_affine):
    rng = np.random.default_rng(c_in * 100 + c_out)
    h = torch.from_numpy(rng.normal(size=(222, c_in)).astype(np.float32))
    w = torch.from_numpy((rng.uniform(-1, 1, (c_in, c_out)) / np.sqrt(c_in)).astype(np.float32))
    b = torch.from_numpy(rng.uniform(-0.1, 0.1, c_out).astype(np.float32))
    affine = None
    if with_affine:
        affine = torch.from_numpy(np.stack([
            rng.normal(0, 0.5, c_in), rng.uniform(0.5, 2.0, c_in), rng.normal(0, 0.3, c_in),
        ]).astype(np.float32))
    padded = pt.pad_layer(h, affine, w, b)
    assert padded[2].shape == (-(-c_in // 4) * 4, -(-c_out // 4) * 4)
    y, mean, var = pt.fused_layer_ref(*padded)
    assert not y[:, c_out:].any() and not mean[c_out:].any() and not var[c_out:].any()
    want = pt.fused_layer_ref(h, affine, w, b)
    for got_t, want_t in zip((y[:, :c_out], mean[:c_out], var[:c_out]), want):
        assert torch.equal(got_t, want_t)


@pytest.mark.parametrize("c", [1, 3, 5, 12], ids=["c1", "c3", "c5", "c12"])
def test_chamfer_padding_is_exact(c):
    rng = np.random.default_rng(c)
    preds = torch.from_numpy(rng.normal(size=(2, 3, 37, c)).astype(np.float32))
    gts = torch.from_numpy(rng.normal(size=(2, 3, 53, c)).astype(np.float32))
    pp, gp = ck.pad_channels(preds, gts)
    assert pp.shape[-1] == gp.shape[-1] == ck.kernel_channels(c)
    assert ck.kernel_channels(c) == {1: 4, 3: 4, 5: 5, 12: 12}[c]
    assert [ck.kernel_channels(k) for k in (6, 7, 8, 9)] == [8, 8, 8, 9]
    assert torch.equal(frame_chamfer(pp, gp), frame_chamfer(preds, gts))
