"""DGCNN's EdgeConv layer in the program's split form (``models/dgcnn.py::
EdgeConvLayer``: per-point products, then ``ops/dgcnn_edge.py``'s edge pass,
CPU path: the plain versions the CUDA kernels are held to) against the
published edge form (``benchmark/reference/pcaa_v4_dgcnn.py::edge_conv``:
the edge tensor ``[x_j − x_i, x_i]``, the 1×1 conv, BatchNorm over every
edge, LeakyReLU, ``amax`` over the neighbours) on the same graph:

- forward and every gradient in f64, to f64 rounding (the split is exact
  algebra), with BatchNorm scales of both signs (a negative scale takes the
  minimum over the neighbours);
- in f32, within f32 rounding of sums over the edges taken in other orders;
- the running statistics (momentum 0.1 towards the mean and the unbiased
  variance, n the edges) and eval mode, which reads them;
- duplicated points, whose tied edges ``amax`` splits its gradient over
  while the edge pass gives it to the first: the weights' gradients agree;
- ``gradcheck`` of the edge pass in f64, train and eval mode.
"""

import numpy as np
import pytest
import torch

from benchmark.reference import pcaa_v4_dgcnn as ref
from opensetgaitrecognition_pcaa_tpu_torch.models.dgcnn import DGCNNSpec, EdgeConvLayer
from opensetgaitrecognition_pcaa_tpu_torch.ops.dgcnn_edge import edge_conv
from opensetgaitrecognition_pcaa_tpu_torch.ops.dgcnn_knn import dgcnn_knn

torch.set_num_threads(1)
SPEC = DGCNNSpec(k=5, widths=(8,))
S = {"slope": SPEC.slope, "bn_eps": SPEC.bn_eps}


def layer_and_input(seed, dtype=torch.float64, c=6, o=8, f=4, n=24, signs=True, dup=0):
    gen = torch.Generator().manual_seed(seed)
    layer = EdgeConvLayer(c, o, SPEC, gen).to(dtype)
    with torch.no_grad():
        scale = torch.rand(o, generator=gen, dtype=dtype) + 0.5
        if signs:
            scale[::2] *= -1
        layer.norm.scale.copy_(scale)
        layer.norm.bias.copy_(torch.rand(o, generator=gen, dtype=dtype) * 0.2 - 0.1)
    h = torch.randn((f, n, c), generator=gen, dtype=dtype)
    if dup:
        h[:, n - dup:] = h[:, :dup]
    return layer, h.requires_grad_()


def published(layer, h, idx):
    p = {"l.weight": layer.weight, "l.norm.scale": layer.norm.scale,
         "l.norm.bias": layer.norm.bias}
    return ref.edge_conv(p, "l", h, idx, S)


def grads(y, layer, h, probe):
    return torch.autograd.grad((y * probe).sum(), [h, layer.weight, layer.norm.scale,
                                                   layer.norm.bias])


@pytest.mark.parametrize("signs", [False, True])
def test_split_form_is_the_published_form_in_f64(signs):
    layer, h = layer_and_input(0, signs=signs)
    idx = dgcnn_knn(h.detach(), SPEC.k)
    y = layer(h)
    want = published(layer, h, idx)
    torch.testing.assert_close(y, want, rtol=1e-12, atol=1e-12)
    probe = torch.randn(y.shape, generator=torch.Generator().manual_seed(1), dtype=y.dtype)
    for name, g, w in zip(("h", "weight", "scale", "bias"), grads(y, layer, h, probe),
                          grads(want, layer, h, probe)):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12, msg=name)


def test_f32_within_rounding():
    layer, h = layer_and_input(2, torch.float32)
    idx = dgcnn_knn(h.detach(), SPEC.k)
    y = layer(h)
    want = published(layer, h, idx)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    probe = torch.randn(y.shape, generator=torch.Generator().manual_seed(3))
    for name, g, w in zip(("h", "weight", "scale", "bias"), grads(y, layer, h, probe),
                          grads(want, layer, h, probe)):
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max()), name


def test_running_statistics_and_eval_mode():
    layer, h = layer_and_input(4)
    idx = dgcnn_knn(h.detach(), SPEC.k)
    rows = torch.arange(h.shape[0])[:, None, None]
    with torch.no_grad():
        xj = h[rows, idx]
        edges = torch.cat([xj - h[:, :, None], h[:, :, None].expand_as(xj)], -1) @ layer.weight.t()
        e = edges.reshape(-1, edges.shape[-1])
        m = e.shape[0]
        mean, var = e.mean(0), e.var(0, unbiased=True)
        layer(h)
        torch.testing.assert_close(layer.norm.mean, 0.1 * mean, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(layer.norm.var, 0.9 + 0.1 * var, rtol=1e-12, atol=1e-12)
        assert m == 4 * 24 * 5
        layer.eval()
        y = layer(h)
        z = (edges - layer.norm.mean) / torch.sqrt(layer.norm.var + SPEC.bn_eps)
        z = z * layer.norm.scale + layer.norm.bias
        want = torch.nn.functional.leaky_relu(z, SPEC.slope).amax(dim=2)
        torch.testing.assert_close(y, want, rtol=1e-12, atol=1e-12)
        layer(h)  # eval mode moves nothing
        torch.testing.assert_close(layer.norm.mean, 0.1 * mean, rtol=1e-12, atol=1e-12)


def test_duplicated_points_weights_gradients_agree():
    """Frames padded by repeated points: a point's copies are tied
    neighbours; ``amax`` splits the gradient over them, the edge pass gives
    it to the first. The weights' gradients, and each point's input
    gradient summed with its copy's, agree."""
    layer, h = layer_and_input(5, dup=10)
    idx = dgcnn_knn(h.detach(), SPEC.k)
    y = layer(h)
    want = published(layer, h, idx)
    torch.testing.assert_close(y, want, rtol=1e-12, atol=1e-12)
    probe = torch.randn(y.shape, generator=torch.Generator().manual_seed(6), dtype=y.dtype)
    probe[:, 14:] = probe[:, :10]  # the copies' outputs feed on alike
    got, exp = grads(y, layer, h, probe), grads(want, layer, h, probe)
    for name, g, w in zip(("weight", "scale", "bias"), got[1:], exp[1:]):
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-12, msg=name)
    both = lambda g: torch.cat([g[:, :10] + g[:, 14:], g[:, 10:14]], dim=1)  # noqa: E731
    torch.testing.assert_close(both(got[0]), both(exp[0]), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("train", [True, False])
def test_gradcheck_f64(train):
    gen = torch.Generator().manual_seed(7)
    f, n, k, o = 2, 7, 3, 3
    h = torch.randn((f, n, 4), generator=gen, dtype=torch.float64)
    idx = dgcnn_knn(h, k)
    ab = torch.randn((f, n, 2 * o), generator=gen, dtype=torch.float64).requires_grad_()
    gamma = torch.tensor([1.3, -0.7, 0.9], dtype=torch.float64, requires_grad=True)
    beta = torch.tensor([0.1, -0.2, 0.05], dtype=torch.float64, requires_grad=True)
    mean = torch.tensor([0.2, -0.1, 0.0], dtype=torch.float64)
    var = torch.tensor([1.5, 0.8, 1.1], dtype=torch.float64)

    def fn(ab, gamma, beta):
        return edge_conv(ab, idx, gamma, beta, mean, var, train, 1e-5, 0.2)[0]

    assert torch.autograd.gradcheck(fn, (ab, gamma, beta), eps=1e-6, atol=1e-6)


@pytest.mark.parametrize("shapes", [((4, 24, 15), (4, 24, 5)), ((4, 24, 16), (4, 23, 5)),
                                    ((4, 24, 16), (4, 24, 30))])
def test_refuses_mismatched_shapes(shapes):
    ab, idx = torch.zeros(shapes[0]), torch.zeros(shapes[1], dtype=torch.int64)
    w = torch.ones(8)
    with pytest.raises(ValueError):
        edge_conv(ab, idx, w, w, w, w, True)


def test_the_slot_order_picks_the_first_extremal_neighbour():
    """Exact ties: the extremum's slot is the first of them, max or min."""
    ab = torch.zeros((1, 3, 4))
    ab[0, :, 2:] = torch.tensor([[1.0, -2.0], [1.0, -2.0], [0.0, 0.0]])
    idx = torch.tensor([[[2, 0, 1], [0, 1, 2], [1, 2, 0]]])
    gamma = torch.tensor([1.0, -1.0])
    y, _, _ = edge_conv(ab.requires_grad_(), idx, gamma, torch.zeros(2), torch.zeros(2),
                        torch.ones(2), True)
    saved = y.grad_fn.saved_tensors
    slot = saved[3]
    assert slot[0, :, 0].tolist() == [1, 0, 0] and slot[0, :, 1].tolist() == [1, 0, 0]
    assert np.isfinite(y.detach().numpy()).all()
