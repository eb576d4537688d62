"""Agglomerative linkage by mutual-nearest-neighbour rounds, and cut tables.

The decode of `HypHCSystem.test_step`: cosine distances between an object's
embeddings, complete (or single, average) linkage in scipy's Z format, and
the tables that cut the dendrogram at every k of the best-k sweep.

Every function takes a batch of objects: D [B, N, N], Z [B, N-1, 4].  The
linkage runs the B objects in lockstep, as a vmap of the reference's
while-loop does: one round updates every object still merging and leaves
the others as they are, so a round costs one host synchronisation, not one
per object.  Selections are plain indexing, which is exact.
"""
import torch

from ..geometry.math_ops import fma, l2_normalize_rn, sqrt_rn, sum_of_squares
from ..geometry.poincare import MIN_NORM, ball_eps

# "infinite distance": inactive slots, the diagonal and merged-away rows and
# columns hold it.  Any value far above 2, the largest cosine distance.
INF = 1e30
_MIN_STAGE = 128  # the stage size below which the state is no longer compacted
_MASK32 = 0xFFFFFFFF
_CHUNK_PAIRS = 1 << 24  # the distance rows go in chunks of about this many pairs


def decode_leaves(x, scale):
    """The decode's leaves: x on the sphere of radius clamp(scale, 1e-4, 1),
    then clamped into the ball, as `project(normalize_to_radius(x, scale))`
    but with the norms rounded exactly (`l2_normalize_rn`, `sqrt_rn`), so
    the card and the CPU give the same bits."""
    x = l2_normalize_rn(x) * torch.clamp(torch.as_tensor(scale), 1e-4, 1.0)
    norm = sqrt_rn(torch.clamp(sum_of_squares(x, keepdim=True), min=MIN_NORM * MIN_NORM))
    maxnorm = 1.0 - ball_eps(x.dtype)
    return torch.where(norm > maxnorm, x / norm * maxnorm, x)


def cosine_distance_matrix(x):
    """Pairwise cosine distances [..., N, N] of x [..., N, F], clipped to [0, 2].

    Computed as |x̂_i - x̂_j|^2 / 2, never as 1 - x̂_i.x̂_j: the dot form
    cancels for near-parallel embeddings, rounds most small distances to a
    few values (39 % exact zeros on an untrained model) and collapses the
    mutual-NN linkage.  The difference form keeps fp32's relative precision
    and is exactly symmetric.  Squares accumulate as fp32 FMAs in dimension
    order (`fma`), square roots are correctly rounded, so the card and the
    CPU give the same bits.
    """
    lead, (N, F) = x.shape[:-2], x.shape[-2:]
    x = x.reshape(-1, N, F)
    xn = l2_normalize_rn(x)
    D = torch.empty((x.shape[0], N, N), dtype=x.dtype, device=x.device)
    rows = max(1, _CHUNK_PAIRS // max(x.shape[0] * N, 1))
    for r0 in range(0, N, rows):
        blk = xn[:, r0:r0 + rows]
        acc = torch.zeros((x.shape[0], blk.shape[1], N), dtype=x.dtype, device=x.device)
        for f in range(F):
            d = blk[:, :, None, f] - xn[:, None, :, f]
            acc = fma(d, d, acc)
        D[:, r0:r0 + rows] = torch.clamp(0.5 * acc, 0.0, 2.0)
    return D.reshape(*lead, N, N)


def merge_cap(M):
    """The most pairs one round merges at M slots.  Merging any subset of the
    mutual pairs gives the same dendrogram; the cap, the same as the
    reference's, makes the port merge the same pairs in the same rounds."""
    return max(64, min(M // 8, 512))


def _mul32(a, c):
    """(a * c) mod 2^32 for int64 a in [0, 2^32) and a constant c < 2^32,
    in 16-bit halves of c so no product leaves int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def pair_hash(ids):
    """The symmetric 31-bit hash [B, M, M] of cluster-id pairs that breaks
    exact distance ties (uint32 arithmetic, emulated in int64).

    Tied distances are common (near-parallel embeddings quantise), and the
    first index among ties makes every tied row point at one slot: a star
    with one mutual pair, one merge per round.  A hash of the two cluster
    ids orders ties pseudo-randomly yet consistently; fresh merged ids draw
    fresh hashes.  The top bit is clear, below the non-candidate sentinel.
    """
    a, b = ids[:, None, :], ids[:, :, None]
    hsum = _mul32(a + b, 0x9E3779B1)
    hprod = _mul32((a * b) & _MASK32, 0x85EBCA77)
    h = hsum ^ hprod
    return (h ^ (h >> 13)) & 0x7FFFFFFF


class _State:
    """The lockstep state of B objects at M slots."""

    def __init__(self, D):
        B, N, _ = D.shape
        dev = D.device
        self.N = N
        self.D = D
        self.cid = torch.arange(N, device=dev).expand(B, N).clone()
        self.size = torch.ones((B, N), dtype=torch.int64, device=dev)
        self.active = torch.ones((B, N), dtype=torch.bool, device=dev)
        self.Z = torch.zeros((B, max(N - 1, 0), 4), dtype=torch.float32, device=dev)
        self.cursor = torch.zeros(B, dtype=torch.int64, device=dev)
        self.rounds = torch.zeros(B, dtype=torch.int64, device=dev)
        self.lockstep_rounds = 0

    def compact(self, half):
        """Keep the first `half` slots in order of (inactive, slot): the
        surviving clusters stay in slot order."""
        keep = torch.sort((~self.active).to(torch.int32), dim=1, stable=True).indices[:, :half]
        B, M = self.active.shape
        self.D = self.D.gather(1, keep[:, :, None].expand(B, half, M))
        self.D = self.D.gather(2, keep[:, None, :].expand(B, half, half))
        self.cid = self.cid.gather(1, keep)
        self.size = self.size.gather(1, keep)
        self.active = self.active.gather(1, keep)


def _round(s, go, method):
    """One mutual-NN round on the objects where `go` [B] holds.

    Each active cluster's nearest neighbour is the smallest distance in its
    column (D is exactly symmetric), ties broken by the smallest pair hash
    and then the smallest slot.  Mutual pairs merge, the leader (the lower
    slot) taking the merged cluster, at most `merge_cap(M)` leaders per
    object in slot order.  A merge elsewhere only moves other clusters away
    (complete and single take the max or min of two values each at least
    the pair's distance, average a convex combination), so every unmerged
    mutual pair stays mutual and the dendrogram is the sequential one.
    """
    D, N = s.D, s.N
    B, M, _ = D.shape
    dev = D.device
    slots = torch.arange(M, device=dev)
    nn_val = D.min(dim=1).values  # [B, M]
    tie = D == nn_val[:, None, :]
    nn_idx = torch.where(tie, pair_hash(s.cid), _MASK32).argmin(dim=1)
    mutual = s.active & (nn_idx.gather(1, nn_idx) == slots)
    lead_all = mutual & (slots < nn_idx) & go[:, None]
    rank = torch.cumsum(lead_all.to(torch.int64), dim=1) - 1
    leader = lead_all & (rank < merge_cap(M))
    dead = mutual & (slots > nn_idx) & leader.gather(1, nn_idx)
    n_pairs = leader.sum(dim=1)

    bi, li = leader.nonzero(as_tuple=True)  # pairs, in (object, rank) order
    if bi.numel():
        pi = nn_idx[bi, li]
        ki = rank[bi, li]
        ci, cj = s.cid[bi, li], s.cid[bi, pi]
        s.Z[bi, s.cursor[bi] + ki] = torch.stack(
            [torch.minimum(ci, cj).float(), torch.maximum(ci, cj).float(),
             nn_val[bi, li], (s.size[bi, li] + s.size[bi, pi]).float()], dim=-1)

        Rl, Rp = D[bi, li], D[bi, pi]  # [P, M]
        nn_rows = nn_idx[bi]  # [P, M]: each column's partner slot
        if method == "complete":
            R = torch.maximum(Rl, Rp)
            C = torch.maximum(R, R.gather(1, nn_rows))
        elif method == "single":
            R = torch.minimum(Rl, Rp)
            C = torch.minimum(R, R.gather(1, nn_rows))
        else:  # average, size-weighted, each weighted sum one FMA
            sl = s.size[bi, li].float()[:, None]
            sp = s.size[bi, pi].float()[:, None]
            R = torch.where((Rl < INF) & (Rp < INF),
                            fma(sl, Rl, sp * Rp) / torch.clamp(sl + sp, min=1.0), INF)
            # merged-to-merged: the column's leader and its partner, weighted
            # by their sizes, then the mean of the two roundings of each pair
            # so the matrix stays exactly symmetric
            scol = s.size[bi].float()
            spcol = scol.gather(1, nn_rows)
            Rn = R.gather(1, nn_rows)
            C = torch.where((R < INF) & (Rn < INF),
                            fma(scol, R, spcol * Rn) / torch.clamp(scol + spcol, min=1.0), INF)
            pair_of = torch.zeros((B, M), dtype=torch.int64, device=dev)
            pair_of[bi, li] = torch.arange(bi.numel(), device=dev)
            C = 0.5 * (C + C[pair_of[bi], li[:, None]])
        # a merged cluster's new row: to leaders the merged-to-merged value,
        # to the absorbed partners INF, to everything else R
        Rfix = torch.where(leader[bi], C, torch.where(dead[bi], INF, R))
        D[bi, :, li] = Rfix
        D.masked_fill_(dead[:, None, :], INF)
        D.masked_fill_(dead[:, :, None], INF)
        D[bi, li, :] = Rfix
        D[bi, li, li] = INF
        s.size[bi, li] += s.size[bi, pi]
        s.cid[bi, li] = N + s.cursor[bi] + ki
    s.active &= ~dead
    s.cursor += n_pairs
    s.rounds += go.to(torch.int64)
    s.lockstep_rounds += 1


def _run(s, method, target=None):
    """Rounds until every object is done: all merged, N rounds (so an
    all-NaN D ends), or at most `target` active clusters."""
    N = s.N
    while True:
        go = (s.cursor < N - 1) & (s.rounds < N)
        if target is not None:
            go &= s.active.sum(dim=1) > target
        if not bool(go.any()):
            return
        _round(s, go, method)


def linkage_from_distances_mnn(D, method="complete", return_rounds=False):
    """Linkage Z [B, N-1, 4] (scipy format) of distance matrices D [B, N, N].

    Complete, single and average linkage are reducible, so merging every
    mutually-nearest pair at once gives the sequential dendrogram (the
    NN-chain theorem), in tens of rounds instead of N - 1 merges.  The state
    is compacted as the active count falls (to 3/4 while M >= 2048, then by
    halves down to 128 slots), at the reference's stages, so that tied data
    merges the same pairs in the same rounds.  Rows are then stable-sorted
    by height (children precede equal-height parents: they merge in earlier
    rounds) and merged ids renumbered to row order.

    With return_rounds, also returns the lockstep rounds run and the rounds
    of each object [B].  D [N, N] gives Z [N-1, 4].
    """
    if method not in ("complete", "single", "average"):
        raise ValueError(f"unknown linkage method {method!r}")
    unbatched = D.dim() == 2
    D = D[None] if unbatched else D
    B, N, _ = D.shape
    D = D.to(torch.float32)
    # exact symmetry, which mutual pairs need; the rounds update this copy in place
    D = 0.5 * (D + D.transpose(1, 2))
    D.diagonal(dim1=1, dim2=2).fill_(INF)
    s = _State(D)
    M = N
    while M > _MIN_STAGE:
        M_next = max(_MIN_STAGE, (3 * M + 3) // 4 if M >= 2048 else (M + 1) // 2)
        _run(s, method, target=M_next)
        s.compact(M_next)
        M = M_next
    _run(s, method)
    Z = _sort_and_renumber(s.Z, N)
    Z = Z[0] if unbatched else Z
    return (Z, s.lockstep_rounds, s.rounds) if return_rounds else Z


def _sort_and_renumber(Z, N):
    """Stable sort of the rows by height; merged ids renumbered to row order."""
    perm = torch.sort(Z[..., 2], dim=-1, stable=True).indices
    Zs = Z.gather(1, perm[..., None].expand_as(Z))
    inv = torch.empty_like(perm)
    inv.scatter_(1, perm, torch.arange(N - 1, device=Z.device).expand_as(perm))
    inv = inv.float()

    def remap(col):
        old_row = torch.clamp(col.long() - N, 0, N - 2)
        return torch.where(col >= N, N + inv.gather(1, old_row), col)

    a, b = remap(Zs[..., 0]), remap(Zs[..., 1])
    return torch.stack([torch.minimum(a, b), torch.maximum(a, b), Zs[..., 2], Zs[..., 3]], -1)


# ---------------------------------------------------------------- cut tables

def _doubling_steps(n):
    s, k = 1, 0
    while s < 2 * n:
        s *= 2
        k += 1
    return k


def _invert_children(Z):
    """(child_row, is_b) [B, 2N-1]: the row that absorbs each node, and 1
    where it is that row's second child.  Every node but the root (2N-2) is
    a child of exactly one row, so sorting the child ids inverts the map;
    the root gets the sentinel row N-1."""
    B, N = Z.shape[0], Z.shape[1] + 1
    dev = Z.device
    ids = torch.cat([Z[..., 0], Z[..., 1]], dim=1).long()
    order = torch.sort(ids, dim=1, stable=True).indices
    rows2 = torch.arange(N - 1, device=dev).repeat(2).expand(B, -1)
    isb2 = torch.cat([torch.zeros(N - 1, dtype=torch.int64, device=dev),
                      torch.ones(N - 1, dtype=torch.int64, device=dev)]).expand(B, -1)
    child_row = torch.cat([rows2.gather(1, order),
                           torch.full((B, 1), N - 1, dtype=torch.int64, device=dev)], 1)
    is_b = torch.cat([isb2.gather(1, order), torch.zeros((B, 1), dtype=torch.int64, device=dev)], 1)
    return child_row, is_b


def build_cut_tables(Z):
    """(child_row [B, 2N-1], up [L, B, 2N-1], is_b [B, 2N-1]) for cutting Z
    [B, N-1, 4] at many levels: `up[j]` is each node's 2^j-th ancestor (the
    root its own), `child_row` strictly rises from leaf to root, and
    2 (child_row[root] - m) + is_b[root] labels the clusters after m merges
    without collisions."""
    N = Z.shape[1] + 1
    child_row, is_b = _invert_children(Z)
    nodes = torch.arange(2 * N - 1, device=Z.device)
    parent = torch.where(nodes == 2 * N - 2, nodes, N + child_row)
    ups = [parent]
    for _ in range(_doubling_steps(N) - 1):
        ups.append(ups[-1].gather(1, ups[-1]))
    return child_row, torch.stack(ups), is_b


def _climb_to_cut(child_row, up, num_merges):
    """Each leaf's cluster root [B, N] after the first `num_merges` merges:
    lift to the last ancestor merged before the cut, then one step up."""
    N = (child_row.shape[1] + 1) // 2
    cur = torch.arange(N, device=child_row.device).expand(child_row.shape[0], N)
    merged = child_row.gather(1, cur) < num_merges
    for j in range(up.shape[0] - 1, -1, -1):
        nxt = up[j].gather(1, cur)
        cur = torch.where(merged & (child_row.gather(1, nxt) < num_merges), nxt, cur)
    return torch.where(merged, up[0].gather(1, cur), cur)


def _relabel_consecutive(roots):
    """Root ids [..., N] -> labels 0..C-1 in ascending order of root id."""
    order = torch.sort(roots, dim=-1, stable=True).indices
    sr = roots.gather(-1, order)
    step = torch.cat([torch.zeros_like(sr[..., :1]), (sr[..., 1:] != sr[..., :-1]).long()], -1)
    out = torch.empty_like(order)
    return out.scatter_(-1, order, torch.cumsum(step, dim=-1))


def cut_roots_sweep(Z, child_row, up, is_b, k_hi):
    """Roots and collision-free labels (< 2 k_hi) of every cut k = k_hi .. 1.

    One climb finds the deepest cut; each shallower one applies the next
    merge row (the clusters that are its children re-root to it).  Returns
    (roots [B, k_hi, N], labels [B, k_hi, N], ks [k_hi]).
    """
    N = Z.shape[1] + 1
    m0 = N - k_hi
    roots = _climb_to_cut(child_row, up, m0)
    cr = child_row.gather(1, roots)
    ib = is_b.gather(1, roots)
    a, b = Z[..., 0].long(), Z[..., 1].long()
    all_roots, all_cr, all_ib = [roots], [cr], [ib]
    for r in range(m0, N - 1):
        hit = (roots == a[:, r:r + 1]) | (roots == b[:, r:r + 1])
        roots = torch.where(hit, N + r, roots)
        cr = torch.where(hit, child_row[:, N + r:N + r + 1], cr)
        ib = torch.where(hit, is_b[:, N + r:N + r + 1], ib)
        all_roots.append(roots)
        all_cr.append(cr)
        all_ib.append(ib)
    ks = k_hi - torch.arange(k_hi, device=Z.device)
    ms = N - ks
    labels = 2 * (torch.stack(all_cr, 1) - ms[:, None]) + torch.stack(all_ib, 1)
    return torch.stack(all_roots, 1), labels, ks
