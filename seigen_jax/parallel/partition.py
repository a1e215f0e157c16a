"""Mesh partitioning + halo-exchange planning for SPMD execution.

Rebuild of the reference's distribution layer (SURVEY.md §5.5: DMPlex +
METIS partition, PETSc SF halos, PyOP2 core/owned/halo sets) as a host-side
plan computed once at setup:

  1. Elements are reordered along a Morton space-filling curve and split into
     P equal contiguous blocks (padded with inert elements if P does not
     divide E) — each device owns one block.
  2. Every neighbour-trace reference that crosses a block boundary becomes a
     halo entry.  For each ordered pair of blocks the needed face-node ids
     are collected into a deterministic sorted send list.
  3. The block-pair exchange graph is edge-coloured into K rounds of
     matchings; round k is realised on device as one ``lax.ppermute``
     (payload: face-node values only, SURVEY.md §9.3).
  4. The per-shard ``nbr`` index array is remapped to point into
     [local nodes | ghost pool], so the device-side operators are identical
     to the single-chip ones except for the pool construction.

Everything here is NumPy at setup time; nothing in this module runs on the
device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..mesh.discrete import DiscreteMesh


def morton_order(points: np.ndarray, bits: int = 16) -> np.ndarray:
    """Permutation sorting points along a Morton (Z-order) curve.

    Uses the native C++ path when available; the NumPy bit-interleave below
    is the oracle (tests/test_native.py checks they agree exactly).
    """
    p = points - points.min(axis=0)
    scale = p.max(axis=0)
    scale[scale == 0] = 1.0
    q = np.minimum((p / scale * (2**bits - 1)).astype(np.uint64), 2**bits - 1)

    from ..mesh import native

    if native.available():
        return native.morton_argsort(q.astype(np.uint32), bits=bits)

    dim = points.shape[1]
    code = np.zeros(len(points), dtype=np.uint64)
    for b in range(bits):
        for d in range(dim):
            code |= ((q[:, d] >> np.uint64(b)) & np.uint64(1)) << np.uint64(
                b * dim + d
            )
    return np.argsort(code, kind="stable")


def _edge_color(pairs: list[tuple[int, int]]) -> list[int]:
    """Greedy edge colouring: assign each undirected pair a round such that
    no shard appears twice in one round.  Returns round id per pair."""
    busy: list[set[int]] = []
    colors = []
    for a, b in pairs:
        k = 0
        while k < len(busy) and (a in busy[k] or b in busy[k]):
            k += 1
        if k == len(busy):
            busy.append(set())
        busy[k].update((a, b))
        colors.append(k)
    return colors


@dataclass(frozen=True)
class Plan:
    """Host-side sharding plan (all NumPy)."""

    n_shards: int
    perm: np.ndarray  # (E,) original element id per new slot (pre-padding)
    E: int  # original element count
    E_pad: int  # padded to n_shards * block
    block: int  # elements per shard
    n_rounds: int  # K halo-exchange rounds
    halo_max: int  # H: padded per-round send-list length
    send_idx: np.ndarray  # (P, K, H) int32 local flat node ids to send
    round_perms: tuple  # K tuples of (src, dst) pairs for ppermute
    nbr_local: np.ndarray  # (E_pad, n_faces, n_fp) int32 into local+ghost pool


def make_plan(dm: DiscreteMesh, n_shards: int) -> Plan:
    re = dm.re
    E, n_p = dm.num_elements, re.n_p
    P = n_shards

    perm = morton_order(dm.coords.mean(axis=1))
    block = -(-E // P)  # ceil
    E_pad = block * P

    # new-slot -> old-element; inverse maps old -> new
    inv = np.full(E, -1, dtype=np.int64)
    inv[perm] = np.arange(E)

    # remap nbr to the permuted global node numbering; padded elements are
    # inert self-connected blocks appended at the end of each... simpler:
    # pad at the global end (slots E..E_pad-1), self-connected.
    old_nbr = dm.nbr  # (E, n_faces, n_fp) flat ids into old (E*n_p)
    old_e = old_nbr // n_p
    old_i = old_nbr % n_p
    new_nbr = (inv[old_e] * n_p + old_i).astype(np.int64)  # new numbering
    nbr_perm = new_nbr[perm]  # (E, n_faces, n_fp) rows in new order

    fnodes = re.fnodes  # (n_faces, n_fp)
    pad_rows = np.broadcast_to(
        fnodes[None], (E_pad - E, re.n_faces, re.n_fp)
    ) + (np.arange(E, E_pad) * n_p)[:, None, None]
    nbr_full = np.concatenate([nbr_perm, pad_rows], axis=0)

    # --- halo analysis ---
    shard_of_elem = np.arange(E_pad) // block
    shard_of_node = np.repeat(shard_of_elem, n_p)
    owner = shard_of_node[nbr_full.reshape(-1)].reshape(nbr_full.shape)
    my_shard = shard_of_elem[:, None, None]

    # directed needs: for each (q -> p): sorted unique global node ids
    # (native C++ sort+dedup twin when available — SURVEY §3.1(3); exact
    # oracle test in tests/test_native.py)
    needs: dict[tuple[int, int], np.ndarray] = {}
    cross = owner != my_shard
    if cross.any():
        ce = np.nonzero(cross)
        gids = nbr_full[ce]
        src = owner[ce]
        dst = np.broadcast_to(my_shard, nbr_full.shape)[ce]
        from ..mesh import native as _native

        if _native.available():
            needs = _native.halo_needs(gids, src, dst, P)
        else:
            order = np.lexsort((gids, src, dst))
            gids, src, dst = gids[order], src[order], dst[order]
            key = dst * P + src
            boundaries = np.r_[0, np.nonzero(np.diff(key))[0] + 1,
                               len(key)]
            for a, b in zip(boundaries[:-1], boundaries[1:]):
                q, p_ = int(src[a]), int(dst[a])
                needs[(q, p_)] = np.unique(gids[a:b])

    # undirected pairs + edge colouring
    und = sorted({tuple(sorted(k)) for k in needs})
    colors = _edge_color(und)
    K = max(colors) + 1 if colors else 0
    H = max((len(v) for v in needs.values()), default=1)

    send_idx = np.zeros((P, max(K, 1), H), dtype=np.int32)
    round_perms: list[tuple] = [tuple() for _ in range(max(K, 1))]
    recv_map: dict[tuple[int, int], int] = {}  # (dst, k) -> src (for remap)
    for (a, b), k in zip(und, colors):
        pairs = list(round_perms[k])
        for q, p_ in ((a, b), (b, a)):
            lst = needs.get((q, p_))
            if lst is not None and len(lst):
                # q sends to p_ in round k
                local = (lst - q * block * n_p).astype(np.int32)
                assert local.min() >= 0 and local.max() < block * n_p
                send_idx[q, k, : len(lst)] = local
                pairs.append((q, p_))
                recv_map[(p_, k)] = q
        round_perms[k] = tuple(pairs)

    # --- remap nbr into [local nodes | K*H ghost pool] ---
    pool_base = block * n_p
    nbr_local = np.empty(nbr_full.shape, dtype=np.int32)
    flat = nbr_full.reshape(E_pad, -1)
    out = nbr_local.reshape(E_pad, -1)
    for p_ in range(P):
        rows = slice(p_ * block, (p_ + 1) * block)
        sub = flat[rows]
        res = np.empty_like(sub, dtype=np.int32)
        own = shard_of_node[sub.reshape(-1)].reshape(sub.shape) == p_
        res[own] = (sub[own] - p_ * block * n_p).astype(np.int32)
        if not own.all():
            rem = ~own
            gids = sub[rem]
            pos = np.empty(len(gids), dtype=np.int32)
            done = np.zeros(len(gids), dtype=bool)
            for k in range(K):
                q = recv_map.get((p_, k))
                if q is None:
                    continue
                lst = needs[(q, p_)]
                # gids owned by q -> position in lst
                sel = shard_of_node[gids] == q
                if sel.any():
                    idx = np.searchsorted(lst, gids[sel])
                    assert np.array_equal(lst[idx], gids[sel])
                    pos[sel] = pool_base + k * H + idx
                    done |= sel
            assert done.all(), "halo remap missed entries"
            res[rem] = pos
        out[rows] = res

    return Plan(
        n_shards=P,
        perm=perm,
        E=E,
        E_pad=E_pad,
        block=block,
        n_rounds=K,
        halo_max=H,
        send_idx=send_idx,
        round_perms=tuple(round_perms),
        nbr_local=nbr_local,
    )
