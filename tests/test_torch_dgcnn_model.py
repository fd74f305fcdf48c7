"""PCAA V4 with the DGCNN encoder (``models/dgcnn.py``) on the CPU at small
sizes (T 6, N 24, k 5, EdgeConv widths 8, 8, 16, 16, conv5 to 32, TCN 8..16),
against the plain reference ``benchmark/reference/pcaa_v4_dgcnn.py`` (the
published edge form) from the same seeded weights:

- the encoder's logits, ``sup_fv`` and every leaf's gradient;
- three V4 steps through ``train/pcaa.py::make_epoch_fns`` against the
  reference step with the same rows and noise: each step's losses, each
  leaf's first gradient (Adam's first moment over 1 − b1) and each leaf's
  change after the three steps; the validation pass in eval mode;
- the spans and the edge counter;
- the refusals: what ``_check_supported`` does not carry, the eval path
  and ``convert.py``.

Tolerances: f32 on both sides, the edge sums in other orders (the split
form's per-point products and edge statistics against the edge tensor's
conv and BatchNorm), so agreement is to a few units in 1e-5 of each
quantity's scale.
"""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.reference import params as ref_params
from benchmark.reference import pcaa_v4_dgcnn as ref
from opensetgaitrecognition_pcaa_tpu_torch.config import VARIATION, Config
from opensetgaitrecognition_pcaa_tpu_torch.convert import module_variables
from opensetgaitrecognition_pcaa_tpu_torch.infer.fast_encoder import fused_encoder_apply
from opensetgaitrecognition_pcaa_tpu_torch.models.dgcnn import DGCNNEncoder, DGCNNSpec
from opensetgaitrecognition_pcaa_tpu_torch.train.pcaa import (
    VARIANTS,
    build_pcaa,
    make_epoch_fns,
)
from opensetgaitrecognition_pcaa_tpu_torch.utils import profiling

torch.set_num_threads(1)

SPEC = DGCNNSpec(k=5, widths=(8, 8, 16, 16), emb_dims=32)
DIMS = {"DGCNN_" + f.name.upper(): getattr(SPEC, f.name) for f in dataclasses.fields(SPEC)}
CFG = Config(NMAX=24, NSTEPS=6, NFEATURES=4, SUP_LATENT_DIM=16, TRAIN_CLASSES=(0, 1, 2),
             BATCH_SIZE=4, FUSED_ADAM=True, SEED=3, DTC_FILTERS=(8, 8, 8, 8, 8, 16))
V4_DPH = dataclasses.replace(VARIANTS[VARIATION.V4], use_disc_head=True)


def crops(seed: int, n: int = 12):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 0.4, (n, CFG.NSTEPS, CFG.NMAX, 4)).astype(np.float32)
    x[:, :, 16:] = x[:, :, :8]  # frames padded by repeated points
    return torch.from_numpy(x), torch.from_numpy(rng.integers(0, CFG.n_classes, n))


def seeded(mods, seed: int):
    """The benchmark's seeded weights in the program's modules → the
    reference's copy of them by name."""
    dims = dict(DIMS, NSTEPS=CFG.NSTEPS, NMAX=CFG.NMAX, NFEATURES=4, SUP_LATENT_DIM=16,
                DTC_FILTERS=list(CFG.DTC_FILTERS))
    weights = ref_params.make(ref.leaves(dims, CFG.n_classes), seed, "cpu")
    own = {k: p for m in (mods.g, mods.d) for k, p in m.named_parameters()}
    assert set(own) == set(weights)
    with torch.no_grad():
        for k, p in own.items():
            p.copy_(weights[k])
    return {k: v.clone() for k, v in weights.items()}, dims


def test_encoder_against_reference():
    mods, _ = build_pcaa(CFG, V4_DPH, device="cpu", encoder=SPEC)
    p, dims = seeded(mods, 11)
    enc = mods.g["encoder"]
    assert isinstance(enc, DGCNNEncoder)
    x, _ = crops(1, 3)
    logits, fv = enc(x)
    r_logits, r_fv = ref.encoder({k: v.requires_grad_() for k, v in p.items()}, x, dims)
    torch.testing.assert_close(logits, r_logits, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(fv, r_fv, rtol=1e-5, atol=1e-5)
    probe = torch.from_numpy(np.random.default_rng(2).normal(size=fv.shape)).float()
    names = [k for k, _ in enc.named_parameters()]
    got = torch.autograd.grad(logits.sum() + (fv * probe).sum(), list(enc.parameters()))
    want = torch.autograd.grad(r_logits.sum() + (r_fv * probe).sum(),
                               [p["encoder." + k] for k in names])
    # a conv bias under a train-mode BatchNorm has a gradient of round-off
    # alone: each leaf against the larger of its scale and the median leaf's
    median = float(np.median([float(w.abs().max()) for w in want]))
    for name, g, w in zip(names, got, want):
        scale = max(float(w.abs().max()), median)
        assert float((g - w).abs().max()) <= 2e-5 * scale, name


def test_three_steps_against_reference_step():
    mods, state = build_pcaa(CFG, V4_DPH, device="cpu", encoder=SPEC)
    p, dims = seeded(mods, 5)
    x, y = crops(2)
    perm = np.arange(12).reshape(3, 4)
    rng = np.random.default_rng(7)
    z0 = torch.from_numpy(rng.normal(size=(3, 4, 16)).astype(np.float32))
    alphas = torch.from_numpy(rng.uniform(size=(3, 4, 1)).astype(np.float32))
    params = {**dict(mods.g.named_parameters()), **dict(mods.d.named_parameters())}
    p0 = {k: v.detach().clone() for k, v in params.items()}
    train_epoch, valid_epoch = make_epoch_fns(mods, CFG)
    state, m1 = train_epoch(state, x, y, perm[:1], noise=(z0[:1], alphas[:1]))
    grads = {k: v / (1 - CFG.B1) for opt in (state.opt_g, state.opt_d) for k, v in opt.mu.items()}
    state, m23 = train_epoch(state, x, y, perm[1:], noise=(z0[1:], alphas[1:]))
    losses = [{k: float(v[i]) for k, v in m.items() if k != "n_correct"}
              for m in (m1, m23) for i in range(len(m["tot_loss"]))]

    hp = dict(dims, shape=(CFG.NSTEPS, CFG.NMAX, 4), GP_WEIGHT=CFG.GP_WEIGHT,
              ADV_WEIGHT=CFG.ADV_WEIGHT, LR=CFG.LR, B1=CFG.B1, B2=CFG.B2)
    opt_g, opt_d = {}, {}
    for i in range(3):
        r_losses, r_grads = ref.pcaa_v4_dgcnn_step(p, opt_g, opt_d, x[perm[i]], y[perm[i]], z0[i],
                                                   alphas[i], state.centroids, hp)
        for k, v in r_losses.items():
            assert abs(losses[i][k] - v) <= 1e-5 * max(abs(v), 1.0), (i, k, losses[i][k], v)
        if i == 0:
            median = float(np.median([float(g.norm()) for g in r_grads.values()]))
            for k, g in r_grads.items():
                gap = abs(float(grads[k].norm()) - float(g.norm()))
                assert gap <= 1e-4 * max(float(g.norm()), median), k
            # leaves whose gradient is round-off (the TCN's conv biases under
            # train-mode BatchNorm, the critic's last bias, whose gradients
            # from the fake and real means cancel) or none (the DPH) move by
            # Adam's sign of round-off: left out
            moved = [k for k, g in r_grads.items() if float(g.norm()) >= 1e-3 * median]
    changes = {k: float((params[k].detach() - p0[k]).norm()) for k in moved}
    r_changes = {k: float((p[k] - p0[k]).norm()) for k in moved}
    median = float(np.median(list(r_changes.values())))
    left_out = sorted(set(params) - set(moved))
    assert all(".conv.bias" in k or k.startswith("disc_head.") or k == "discriminator.dense.2.bias"
               for k in left_out), left_out
    for k in moved:
        assert abs(changes[k] - r_changes[k]) <= 1e-3 * max(r_changes[k], median), k

    # the running statistics moved; validation reads them in eval mode
    norm = mods.g["encoder"].edges[0].norm
    assert float(norm.mean.abs().sum()) > 0 and not torch.equal(norm.var, torch.ones_like(norm.var))
    valid = valid_epoch(state, x, y, perm)
    assert all(bool(torch.isfinite(v).all()) for v in valid.values())
    assert mods.training


def test_spans_and_edge_counter():
    mods, _ = build_pcaa(CFG, V4_DPH, device="cpu", encoder=SPEC)
    x, _ = crops(3, 2)
    with profiling.recording() as rec:
        mods.g["encoder"](x)
    names = [s[0] for s in rec.spans]
    assert names.count("dgcnn.edgeconv") == 1 and names.count("dgcnn.point") == 1
    for inner in ("dgcnn.knn", "dgcnn.product", "dgcnn.edge"):
        assert names.count(inner) == 4
        assert all(rec.spans[s[1]][0] == "dgcnn.edgeconv" for s in rec.spans if s[0] == inner)
    assert rec.counters["dgcnn.edges"] == 4 * 2 * CFG.NSTEPS * CFG.NMAX * SPEC.k


@pytest.mark.parametrize("change,spec,words", [
    (dict(FUSED_POINTNET=True), SPEC, "FUSED_POINTNET"),
    (dict(COMPUTE_DTYPE="bfloat16"), SPEC, "f32 compute"),
    (dict(DP_DEVICES=2), SPEC, "one device"),
    (dict(), dataclasses.replace(SPEC, k=300), "one-byte slot"),
    (dict(NMAX=300), SPEC, "300 points"),
])
def test_build_refuses_what_dgcnn_does_not_carry(change, spec, words):
    with pytest.raises(ValueError, match=words):
        build_pcaa(CFG.replace(**change), V4_DPH, device="cpu", encoder=spec)


def test_run_folder_inference_and_trees_refuse_dgcnn():
    mods, _ = build_pcaa(CFG, V4_DPH, device="cpu", encoder=SPEC)
    with pytest.raises(ValueError, match="a DGCNN encoder"):
        fused_encoder_apply(mods.g["encoder"], crops(0, 2)[0], use_kernel=False)
    with pytest.raises(ValueError, match="no JAX tree"):
        module_variables(mods.state_dict())
