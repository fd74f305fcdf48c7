"""Plain PyTorch reference of the PCAA V4 and OR-CED models, their training
steps and the V4 eval encoder, written from the paper (arXiv 2503.07435)
and the reference ``models.py`` / ``PCAA_ablation.py`` / ``train_ORCED.py``.

Functions over a dict of parameters keyed by name (``params.py`` lists the
names and shapes), in f32. Nothing here imports the program under test, JAX
or the JAX package; the caller turns TF32 off (``exact_f32``) or, for the
control, on. Layout is channels-last ``(B, T, N, C)``.

Departures from the reference code, each one the program's too: the
decoder's output is reshaped channels-last; ELU sits on the classifier's
logits; the WGAN-GP term is two-sided; the DPH (discriminator projection
head) maps latent to latent.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

P = Dict[str, torch.Tensor]
BN_EPS = 1e-5
TCN_DILATIONS = (1, 2, 4, 1, 2, 4)


def exact_f32(on: bool = True) -> None:
    """TF32 off for matmuls and convolutions (``on``), or on (the control)."""
    torch.backends.cuda.matmul.allow_tf32 = not on
    torch.backends.cudnn.allow_tf32 = not on


def linear(p: P, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[name + ".weight"].t() + p[name + ".bias"]


def batchnorm(p: P, name: str, x: torch.Tensor, train: bool = True) -> torch.Tensor:
    """BatchNorm over every axis but the last: batch statistics (biased
    variance) in train mode, the running ones in eval mode."""
    if train:
        dims = tuple(range(x.dim() - 1))
        mean = x.mean(dim=dims)
        var = ((x - mean) ** 2).mean(dim=dims)
    else:
        mean, var = p[name + ".mean"], p[name + ".var"]
    return (x - mean) / torch.sqrt(var + BN_EPS) * p[name + ".scale"] + p[name + ".bias"]


def backbone(p: P, prefix: str, x: torch.Tensor, train: bool = True) -> torch.Tensor:
    """PointNet (4 × dense + BN + ELU) → mean over points → 6 causal dilated
    convs (kernel 3) + BN + ELU → mean over time: ``(B, T, N, C) → (B, F)``."""
    h = x
    for i in range(4):
        name = f"{prefix}.pointnet.dense.{i}"
        h = F.elu(batchnorm(p, f"{prefix}.pointnet.norm.{i}", linear(p, name, h), train))
    h = h.mean(dim=2).transpose(1, 2)  # (B, D, T)
    for i, d in enumerate(TCN_DILATIONS):
        name = f"{prefix}.tcn.layers.{i}"
        h = F.conv1d(F.pad(h, (2 * d, 0)), p[name + ".conv.weight"], p[name + ".conv.bias"],
                     dilation=d)
        h = F.elu(batchnorm(p, name + ".norm", h.transpose(1, 2), train)).transpose(1, 2)
    return h.mean(dim=2)


def pcaa_encoder(p: P, x: torch.Tensor, train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """V4's encoder → ``(logits, latent)``: the latent ``elu(MLP_sup1)``, the
    projection head ``elu(MLP_head)``, ELU on the classifier's logits."""
    fv = F.elu(linear(p, "encoder.MLP_sup1", backbone(p, "encoder.backbone", x, train)))
    h = F.elu(linear(p, "encoder.MLP_head", fv))
    return F.elu(linear(p, "encoder.MLP_sup2", h)), fv


def decoder(p: P, prefix: str, z: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """5 dense layers with ELU between them → ``(B, T, N, C)``."""
    for i in range(4):
        z = F.elu(linear(p, f"{prefix}.dense.{i}", z))
    return linear(p, f"{prefix}.dense.4", z).reshape((z.shape[0],) + tuple(shape))


def chamfer(preds: torch.Tensor, gts: torch.Tensor) -> torch.Tensor:
    """Bidirectional sum of nearest squared distances per frame, averaged
    over batch and time."""
    d = ((gts * gts).sum(-1)[..., :, None] + (preds * preds).sum(-1)[..., None, :]
         - 2.0 * gts @ preds.transpose(-1, -2))
    return (d.amin(dim=2).sum(dim=2) + d.amin(dim=3).sum(dim=2)).mean()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits, labels.long())


def critic(p: P, h: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """Conditional WGAN critic ``concat(z, onehot)`` → 64 → 32 → 1, ELU between."""
    h = torch.cat([h, onehot], dim=-1)
    h = F.elu(linear(p, "discriminator.dense.0", h))
    h = F.elu(linear(p, "discriminator.dense.1", h))
    return linear(p, "discriminator.dense.2", h)[:, 0]


def adam_(params: P, grads: P, state: Dict, *, lr: float, b1: float, b2: float,
          eps: float = 1e-8) -> None:
    """One Adam step in place (bias-corrected, eps outside the square root)."""
    state["t"] = t = state.get("t", 0) + 1
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    for k, w in params.items():
        g = grads[k]
        m = state.setdefault("m", {}).setdefault(k, torch.zeros_like(w))
        v = state.setdefault("v", {}).setdefault(k, torch.zeros_like(w))
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * g * g)
        w.sub_(lr * (m / c1) / (torch.sqrt(v / c2) + eps))


def _grads(loss: torch.Tensor, params: P) -> P:
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(w) if g is None else g for (k, w), g in zip(params.items(), gs)}


def pcaa_v4_step(p: P, opt_g: Dict, opt_d: Dict, x: torch.Tensor, labels: torch.Tensor,
                 z0: torch.Tensor, alphas: torch.Tensor, centroids: torch.Tensor, hp: Dict
                 ) -> Tuple[Dict[str, float], P]:
    """One V4 step in place on ``p`` and the two Adam states → (losses,
    the gradients as each Adam gets them).

    One train-mode encoder forward; the critic step on detached latents
    (through the DPH, which no gradient reaches) with the two-sided
    gradient penalty at ``z + α(fake − z)``, ``z = z0 + onehot @ centroids``;
    the critic's Adam step; then the generator's loss (Chamfer of the
    decoder's reconstruction through the decoder head, the adversarial term
    against the updated critic, cross-entropy) and its Adam step."""
    g_keys = [k for k in p if k.split(".")[0] in ("encoder", "dec_head", "decoder")]
    d_keys = [k for k in p if k.split(".")[0] in ("discriminator", "disc_head")]
    pg = {k: p[k].requires_grad_(True) for k in g_keys}
    pd = {k: p[k].requires_grad_(True) for k in d_keys}
    onehot = F.one_hot(labels.long(), centroids.shape[0]).float()
    logits, fv = pcaa_encoder(p, x)
    z = (z0 + onehot @ centroids).detach()
    with torch.no_grad():
        fake = F.elu(linear(p, "disc_head.dense", fv.detach()))
    interp = (z + alphas * (fake - z)).detach().requires_grad_(True)
    (gi,) = torch.autograd.grad(critic(p, interp, onehot).sum(), interp, create_graph=True)
    gp = ((torch.sqrt((gi ** 2).sum(dim=1) + 1e-12) - 1.0) ** 2).mean()
    d_loss = critic(p, fake, onehot).mean() - critic(p, z, onehot).mean() + hp["GP_WEIGHT"] * gp
    d_grads = _grads(d_loss, pd)
    with torch.no_grad():
        adam_(pd, d_grads, opt_d, lr=hp["LR"], b1=hp["B1"], b2=hp["B2"])

    rec = decoder(p, "decoder", F.elu(linear(p, "dec_head.dense", fv)), hp["shape"])
    rec_loss = chamfer(rec, x)
    adv = -critic(p, F.elu(linear(p, "disc_head.dense", fv)), onehot).mean() * hp["ADV_WEIGHT"]
    sup = cross_entropy(logits, labels)
    tot = rec_loss + adv + sup
    g_grads = _grads(tot, pg)
    with torch.no_grad():
        adam_(pg, g_grads, opt_g, lr=hp["LR"], b1=hp["B1"], b2=hp["B2"])
    for w in p.values():
        w.requires_grad_(False)
    losses = {"d_loss": d_loss, "rec_loss": rec_loss, "sup_loss": sup, "tot_loss": tot}
    return {k: float(v.detach()) for k, v in losses.items()}, {**g_grads, **d_grads}


def mean_learner(p: P, onehot: torch.Tensor) -> torch.Tensor:
    """one-hot → 16 → 32 → 64 → latent, train-mode BN + ELU after the first three."""
    h = onehot
    for i in range(3):
        h = F.elu(batchnorm(p, f"mean_learner.norm.{i}", linear(p, f"mean_learner.dense.{i}", h)))
    return linear(p, "mean_learner.dense.3", h)


def triplet_ms(z: torch.Tensor, labels: torch.Tensor, margin: float,
               epsilon: float = 0.1) -> torch.Tensor:
    """Triplet-margin loss over Multi-Similarity-mined pairs (Wang et al.
    2019) of L2-normalized embeddings: the mean over the violating triplets
    (anchor, kept positive, kept negative), 0 where none violates."""
    sim = (z @ z.t()).detach()
    n = z.shape[0]
    same = labels[:, None] == labels[None, :]
    eye = torch.eye(n, dtype=torch.bool, device=z.device)
    pos, neg = same & ~eye, ~same
    inf = torch.tensor(float("inf"), device=z.device)
    hardest_neg = torch.where(neg, sim, -inf).amax(dim=1)
    easiest_pos = torch.where(pos, sim, inf).amin(dim=1)
    keep_pos = pos & (sim < hardest_neg[:, None] + epsilon)
    keep_neg = neg & (sim > easiest_pos[:, None] - epsilon)
    sq = (z * z).sum(1)
    dist = torch.sqrt(torch.clamp(sq[:, None] + sq[None, :] - 2.0 * z @ z.t(), min=0) + 1e-16)
    viol = F.relu(dist[:, :, None] - dist[:, None, :] + margin)
    viol = viol * (keep_pos[:, :, None] & keep_neg[:, None, :])
    count = (viol > 0).sum()
    return viol.sum() / count.clamp(min=1) if int(count) else viol.sum() * 0.0


def orced_step(p: P, opt: Dict, x: torch.Tensor, labels: torch.Tensor, eps: torch.Tensor,
               kl_mult: float, hp: Dict) -> Tuple[Dict[str, float], P]:
    """One OR-CED step in place → (losses, gradients): Chamfer + CE + MS
    triplet on the normalized latent + the conditional-Gaussian KL against
    the mean learner's output times ``kl_mult``, one Adam whose second
    decay is B1 (the reference's ``betas=(B1, B1)``)."""
    for w in p.values():
        w.requires_grad_(True)
    n = hp["n_classes"]
    onehot = F.one_hot(labels.long(), n).float()
    feats = backbone(p, "encoder.backbone", x)
    mu = linear(p, "encoder.MLP_mu", feats)
    logvar = linear(p, "encoder.MLP_logvar", feats)
    z = mu + eps * torch.exp(0.5 * logvar)
    logits = linear(p, "encoder.MLP_classification", z)
    rec_loss = hp["REC_W"] * chamfer(decoder(p, "decoder", z, hp["shape"]), x)
    sup = hp["CE_W"] * cross_entropy(logits, labels)
    trip = hp["TRIPLET_W"] * triplet_ms(z / torch.linalg.norm(z, dim=1, keepdim=True), labels,
                                        hp["TRIPLET_MARGIN"])
    mu_k = mean_learner(p, onehot)
    kl = -0.5 * torch.sum(1.0 + logvar - (mu - mu_k) ** 2 - torch.exp(logvar), dim=1).mean()
    kl = hp["KL_W"] * kl * kl_mult
    tot = rec_loss + sup + trip + kl
    grads = _grads(tot, p)
    with torch.no_grad():
        adam_(p, grads, opt, lr=hp["LR"], b1=hp["B1"], b2=hp["B1"])
    for w in p.values():
        w.requires_grad_(False)
    losses = {"rec_loss": rec_loss, "sup_loss": sup, "trip_loss": trip, "kl_loss": kl,
              "tot_loss": tot}
    return {k: float(v.detach()) for k, v in losses.items()}, grads


@torch.no_grad()
def pcaa_eval(p: P, x: torch.Tensor, block: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode V4 encoder (running statistics) over ``x`` in blocks of
    rows → ``(logits, latent)``."""
    outs = [pcaa_encoder(p, x[i:i + block], train=False) for i in range(0, x.shape[0], block)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def log_joint_likelihood(fv: torch.Tensor, means: torch.Tensor) -> torch.Tensor:
    """f64 log of the equal-weight mixture of unit Gaussians at ``means``."""
    x, m = fv.double(), means.double()
    sq = ((x[:, None, :] - m[None, :, :]) ** 2).sum(-1)
    log_pdf = -0.5 * sq - 0.5 * m.shape[1] * math.log(2.0 * math.pi)
    return torch.logsumexp(log_pdf, dim=1) - math.log(m.shape[0])

