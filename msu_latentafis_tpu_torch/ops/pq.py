"""Product quantization: encoding, decoding and codebook training.

Counterpart of the JAX package's ``ops/pq.py``. Reference semantics (the
reference implementation's extraction/descriptor_PQ.py): per-6-d-subspace
nearest-centroid assignment -> uint8 codes (:19-27); per-subspace k-means,
Ks 256, 20 iterations, initialized from data points (:41-77).

Distances take the expansion ||x||^2 - 2 x.c + ||c||^2 in f32, as the JAX
package's ``_assign`` does, and the argmin keeps the first minimum. The 16
subspaces go through one batched product, in chunks of rows that bound its
[S, n, K] temporary. On the CPU a row's distances do not depend on the
other rows of its batch, once the batch has two rows or more (a product of
one row takes another summation order), so a single row is computed as
two. On a CUDA device the products are cuBLAS's, in f32 (TF32 off while
they run), and their sums may round otherwise than the CPU's; so every
(row, subspace) whose two best distances lie within ``tie_bound`` (the
expansion's rounding bound) is refined: its distances are computed again
on the host by the CPU path, in one product per subspace, and its code is
the CPU's. Codes on the card thus equal the CPU's; ``assign_rows.refined``
counts the refined entries.

The Lloyd step sums each cluster's rows as a segment sum over the rows
sorted stably by centroid: in row order within a cluster, as the JAX
package's ``segment_sum`` adds them on the CPU, and with no float atomics,
so two runs on one card give the same bits.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

ENCODE_ROWS = 65536      # rows per batched distance product: its [16, n,
#                          256] f32 temporary stays at 1 GiB


@contextlib.contextmanager
def f32_matmul():
    """The f32 products inside run in f32, not TF32 (restored after)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _distances(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """The expansion, x [S, n, d] against centroids [S, K, d] -> [S, n, K];
    on the CPU a batch of one row is computed as two."""
    if x.device.type == "cpu" and x.shape[1] == 1:
        return _distances(x.expand(-1, 2, -1), centroids)[:, :1]
    return ((x * x).sum(dim=2, keepdim=True)
            - torch.bmm(2.0 * x, centroids.transpose(1, 2))
            + (centroids * centroids).sum(dim=2)[:, None, :])


def tie_bound(x: torch.Tensor, second: torch.Tensor) -> torch.Tensor:
    """Per (subspace, row) of x [S, n, d], given its second-best distance:
    the gap between the two best within which two f32 evaluations of the
    expansion, summed in any orders, may pick different centroids. Each
    distance d_j is within E_j = gamma_{d+2} (||x|| + ||c_j||)^2 of exact
    (``code_flip_bound`` bounds it per centroid); a centroid that can
    compete lies within sqrt(second) + 1/4 of x, so its norm is below
    ||x|| + sqrt(second) + 1/4, and one farther off trails by more than
    1/16 (with norms below 50, four such E stay under 1/50). The gap must
    exceed twice two such E: 4 gamma (2 ||x|| + sqrt(second) + 1/4)^2."""
    d = x.shape[-1]
    u = 2.0 ** -24
    gamma = (d + 2) * u / (1 - (d + 2) * u)
    reach = 2.0 * x.norm(dim=2) + torch.sqrt(second.clamp(min=0.0)) + 0.25
    return 4.0 * gamma * reach * reach


def _assign(x: torch.Tensor, centroids: torch.Tensor):
    """Nearest centroid per row and subspace: x [S, n, d], centroids
    [S, K, d] -> ([S, n] int64, the first minimum; on a CUDA device also
    the [S, n] mask of entries whose two best lie within ``tie_bound``)."""
    d2 = _distances(x, centroids)
    if x.device.type == "cpu":
        return torch.argmin(d2, dim=2), None
    return _rank(d2, x)


def _rank(d2: torch.Tensor, x: torch.Tensor):
    """Distances d2 [S, n, K] (overwritten) of rows x -> (the minimum's
    index [S, n], the mask of entries whose second best lies within
    ``tie_bound`` of it; an exact tie always does)."""
    best, out = d2.min(dim=2)
    second = d2.scatter_(2, out[..., None], float("inf")).amin(dim=2)
    return out, (second - best) <= tie_bound(x, second)


def _refine(x: torch.Tensor, centroids: torch.Tensor, out: torch.Tensor,
            subs: torch.Tensor, rows: torch.Tensor) -> None:
    """The CPU path's codes for the tied entries (subs, rows) of x, written
    into ``out``: each subspace's tied rows in one product on the host."""
    xt, cs = x[subs, rows].cpu(), centroids.cpu()
    hs = subs.cpu()
    codes = torch.empty(len(hs), dtype=torch.int64)
    for j in torch.unique(hs).tolist():
        m = hs == j
        codes[m] = torch.argmin(_distances(xt[m][None], cs[j:j + 1]),
                                dim=2)[0]
    out[subs, rows] = codes.to(out.device)


def assign_rows(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """``_assign`` over x [S, N, d] in chunks of ENCODE_ROWS -> [S, N]; on
    a CUDA device the tied entries of every chunk are then refined."""
    S, N, _ = x.shape
    out = torch.empty((S, N), dtype=torch.int64, device=x.device)
    tied = None if x.device.type == "cpu" else \
        torch.empty((S, N), dtype=torch.bool, device=x.device)
    with f32_matmul():
        for a in range(0, N, ENCODE_ROWS):
            out[:, a:a + ENCODE_ROWS], t = _assign(x[:, a:a + ENCODE_ROWS],
                                                   centroids)
            if tied is not None:
                tied[:, a:a + ENCODE_ROWS] = t
    if tied is not None:
        subs, rows = torch.nonzero(tied, as_tuple=True)
        assign_rows.refined += len(subs)
        if len(subs):
            _refine(x, centroids, out, subs, rows)
    return out


assign_rows.refined = 0      # entries refined on the host, on a CUDA device


def pq_codes(des: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Encode f32 [N, S*d] descriptors on their device -> uint8 codes
    [N, S] (codebook [S, K, d] on the same device)."""
    S, _, d = codebook.shape
    N, D = des.shape
    if D != S * d:
        raise ValueError(f"descriptor width {D} != {S} x {d}")
    x = des.reshape(N, S, d).transpose(0, 1)
    return assign_rows(x, codebook).transpose(0, 1).to(torch.uint8)


def pq_encode(des: np.ndarray, codebook: np.ndarray,
              device="cuda") -> np.ndarray:
    """Encode [N, M*Ds] descriptors -> uint8 codes [N, M] on ``device``.

    Rows are independent, so there is no padding to compile buckets (the
    JAX package's ``pad_to`` bounds its XLA compiles)."""
    cb = torch.as_tensor(np.asarray(codebook, np.float32), device=device)
    x = torch.as_tensor(np.asarray(des, np.float32), device=device)
    return pq_codes(x, cb).cpu().numpy()


def pq_decode(codes: np.ndarray, codebook: np.ndarray) -> np.ndarray:
    """Decode uint8 codes [N, M] -> [N, M*Ds] reconstructions (host)."""
    n_subs, n_clusters, sub_dim = codebook.shape
    parts = [codebook[m][codes[:, m].astype(int)] for m in range(n_subs)]
    return np.concatenate(parts, axis=1).astype(np.float32)


def code_flip_bound(des: np.ndarray, codebook: np.ndarray,
                    codes_a: np.ndarray, codes_b: np.ndarray) -> np.ndarray:
    """Where two encodings of the same rows differ, how far apart the two
    codes may lie and still be chosen by f32 expansions summed in any
    order: E_a + E_b, with E_j = gamma_{d+2} (||x||^2 + 2 |x|.|c_j| +
    ||c_j||^2) the rounding bound of one expansion of a d-term subspace
    (gamma_k = k u / (1 - k u), u = 2^-24). Returns [n_diff, 2]: the f64
    distance gap |d_a - d_b| and its bound, per differing (row, subspace).
    """
    S, _, d = codebook.shape
    x = np.asarray(des, np.float64).reshape(len(des), S, d)
    cb = np.asarray(codebook, np.float64)
    rows, subs = np.nonzero(codes_a != codes_b)
    u = 2.0 ** -24
    gamma = (d + 2) * u / (1 - (d + 2) * u)
    xs = x[rows, subs]
    out = []
    for codes in (codes_a, codes_b):
        c = cb[subs, codes[rows, subs].astype(int)]
        dist = ((xs - c) ** 2).sum(axis=1)
        err = gamma * ((xs * xs).sum(1) + 2 * np.abs(xs * c).sum(1)
                       + (c * c).sum(1))
        out.append((dist, err))
    (da, ea), (db, eb) = out
    return np.stack([np.abs(da - db), ea + eb], axis=1)


def lloyd_step(x: torch.Tensor, centroids: torch.Tensor):
    """One Lloyd iteration on every subspace: x [S, N, d], centroids
    [S, K, d] -> (new centroids, assignments [S, N]). A centroid whose
    cluster is empty keeps its place (the JAX package's ``_lloyd_step``)."""
    S, N, d = x.shape
    K = centroids.shape[1]
    assign = assign_rows(x, centroids)
    seg = (assign + K * torch.arange(S, device=x.device)[:, None]).reshape(-1)
    order = torch.sort(seg, stable=True).indices
    counts = torch.bincount(seg, minlength=S * K)
    sums = torch.segment_reduce(x.reshape(S * N, d)[order], "sum",
                                lengths=counts, axis=0)
    new = sums / torch.clamp(counts, min=1).to(torch.float32)[:, None]
    new = torch.where((counts > 0)[:, None], new, centroids.reshape(S * K, d))
    return new.reshape(S, K, d), assign


def init_indices(N: int, n_subs: int, n_clusters: int,
                 seed: int) -> np.ndarray:
    """Each subspace's initial centroids' rows [S, K]: the JAX package's
    ``default_rng(seed).choice`` draws, one subspace after another."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(N, size=n_clusters, replace=False)
                     for _ in range(n_subs)])


def train_codebook(des: np.ndarray, n_subs: int = 16, n_clusters: int = 256,
                   iters: int = 20, seed: int = 0,
                   device="cuda") -> np.ndarray:
    """Per-subspace k-means codebook [n_subs, n_clusters, sub_dim]
    (descriptor_PQ.py:41-77: Ks=256, 20 iterations, point init), every
    subspace in one batched step on ``device``."""
    des = np.asarray(des, np.float32)
    N, D = des.shape
    if D % n_subs:
        raise ValueError(f"descriptor width {D} is not a multiple of "
                         f"{n_subs} subspaces")
    if N <= n_clusters:
        raise ValueError("need more training vectors than clusters")
    d = D // n_subs
    init = torch.as_tensor(init_indices(N, n_subs, n_clusters, seed),
                           device=device)
    x = torch.as_tensor(des, device=device).reshape(N, n_subs, d) \
        .transpose(0, 1).contiguous()
    c = torch.gather(x, 1, init[:, :, None].expand(-1, -1, d))
    for _ in range(iters):
        c, _ = lloyd_step(x, c)
    return c.cpu().numpy()
