"""The kNN graph kernel's share of its roofline, in % (``csrc/dgcnn_knn.cu``).

Per step and EdgeConv layer, over ``F = B·T`` frames of ``N`` points and the
layer's ``C`` input channels. Operations a frame: the distance of each
unordered pair, the point with itself included, ``3·C·N(N+1)/2`` (a
difference, a product and a sum a channel, which the contract keeps apart;
the contract's distance is symmetric bit for bit, since ``(a − b)²`` equals
``(b − a)²``, so one of each ordered pair suffices), and the selection's
``k·N`` comparisons a row, ``k`` rounds of a minimum over the row, with
``k = min(k, N)``. These run at the f32 (non-tensor) peak. Bytes: the
features in (4 bytes a point and channel) and the indices out (8 bytes
each) at the memory's. Whichever bounds it, summed over the layers and the
segment's steps, over the device time of the kernel."""

from benchmark import tracing
from benchmark.flops.pcaa_dgcnn import layer_widths


def frame_ops(n, c, k):
    """The least operations of one frame's graph: the unordered pairs'
    distances and the selection's comparisons."""
    k = min(k, n)
    return 3 * c * n * (n + 1) // 2 + k * n * n


def step_bound(dims, batch):
    """The least seconds of one step's graphs."""
    frames, n, k = batch * dims["NSTEPS"], dims["NMAX"], dims["DGCNN_K"]
    return sum(tracing.bound(frames * frame_ops(n, c, k), frames * n * (4 * c + 8 * min(k, n)),
                             "f32")
               for c, _ in layer_widths(dims))


def read(trace):
    c = trace.cell
    return tracing.roofline(trace, "dgcnn_knn", step_bound(c["dims"], c["batch"])
                            * trace.work["steps"])
