"""Array-of-nodes search tree (mctx-style), batched over boards.

Replaces the reference's pointer tree (cc/mcts/tree.h TreeNode: 362 child
pointers, value stats, NN priors) with preallocated [B, N, ...] arrays:
each Gumbel simulation allocates at most one node, so N = n_sims + 1 slots
suffice. Per-node log-prior storage is softmax-invariant everywhere it's
consumed (improved policy, Gumbel ranking), so raw logits are not kept.

Sign conventions mirror tree.h:95-162: `v` is from the perspective of the
player to move at that node; Q(parent, a) = -v[child]; missing children
read as kMinQ (init-to-loss).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from p3achygo_tpu.constants import NUM_LOCS, NUM_MOVES

# Q bounds (cc/mcts/constants.h:6-11).
MIN_Q = -1.5
MAX_Q = 1.5
NUM_V_BUCKETS = 51
V_BUCKET_RANGE = 2.0 / NUM_V_BUCKETS

NO_CHILD = jnp.int32(-1)

# int16 edge_n saturation ceiling: backprop adds clamp here instead of
# wrapping negative (cross-move tree reuse + GTP ponder slices can push a
# hot PV edge past int16 range; a saturated count only flattens the visit
# distribution's tail, a wrapped one corrupts Q and the improved policy).
EDGE_N_MAX = 2**15 - 1


def saturating_edge_add(edge_n: jnp.ndarray, inc: jnp.ndarray) -> jnp.ndarray:
    """edge_n + inc clamped to EDGE_N_MAX, in the edge_n dtype.

    The int32 intermediate fuses into the elementwise write (no extra HBM
    pass); `inc` may be f32 (one-hot einsum output) or integer.
    """
    s = edge_n.astype(jnp.int32) + inc.astype(jnp.int32)
    return jnp.minimum(s, EDGE_N_MAX).astype(edge_n.dtype)


class Tree(NamedTuple):
    """Batched node arrays. B leading, N = max nodes.

    Child statistics are kept EDGE-indexed (`edge_n`/`edge_w` [B, N, 362],
    like the reference's per-node child_visits, tree.h:44) in addition to
    the node arrays: in a tree (no transpositions) an edge's stats equal
    its child node's, and edge indexing lets the descent read all children
    of a node with a one-hot row contraction instead of a generic
    per-row gather.
    """

    # HBM-dtype notes: the [B, N, 362] arrays dominate sweep traffic
    # (every _sweep_action_table pass streams them), so `children` and
    # `edge_n` are int16 (node indices < 32k, per-edge visits < 32k even
    # at the GTP ponder cap) and `log_priors` is bf16 (log-softmax in
    # [-40, 0]; consumers upcast to f32 before arithmetic). Scatter writes
    # must cast values to the field dtype explicitly.

    n: jnp.ndarray  # int32[B, N] visit count
    w: jnp.ndarray  # f32[B, N] summed utility (own perspective)
    w_outcome: jnp.ndarray  # f32[B, N] summed outcome value
    score_sum: jnp.ndarray  # f32[B, N] running mean * n of score est
    v_var_sum: jnp.ndarray  # f32[B, N] n * Var(v) (incremental, tree.h:810)
    vz_var_sum: jnp.ndarray  # f32[B, N] n * Var(v_outcome) (tree.h:52)
    # n * M3(v): non-standardized third central moment (tree.h:46 v_m3),
    # consumed by the experimental M3 bonus / PUCT-V variants
    # (search_policy.h:277-302). Maintained by the Pébay online update
    # (welford_m3_delta) — the reference recomputes it as a mixture over
    # children (tree.h:198-228); ours tracks the backed-up observation
    # stream like v_var_sum does (documented deviation, same as variance).
    v_m3_sum: jnp.ndarray  # f32[B, N]
    init_util: jnp.ndarray  # f32[B, N]
    init_outcome: jnp.ndarray  # f32[B, N]
    init_score: jnp.ndarray  # f32[B, N]
    init_err: jnp.ndarray  # f32[B, N] NN uncertainty sqrt(err2), tree.h:55
    log_priors: jnp.ndarray  # bf16[B, N, 362] log-softmax of NN policy
    children: jnp.ndarray  # int16[B, N, 362] node index or -1
    edge_n: jnp.ndarray  # int16[B, N, 362] per-edge visit count
    edge_w: jnp.ndarray  # f32[B, N, 362] per-edge summed child utility
    edge_wz: jnp.ndarray  # f32[B, N, 362] per-edge summed child outcome
    color: jnp.ndarray  # int8[B, N] player to move at node
    is_terminal: jnp.ndarray  # bool[B, N]
    evaluated: jnp.ndarray  # bool[B, N]
    next_free: jnp.ndarray  # int32[B] node allocation cursor
    v_categorical: jnp.ndarray  # int32[B, N, 51] outcome-value histogram
    parent: jnp.ndarray  # int32[B, N] allocation parent (-1 for root)
    parent_action: jnp.ndarray  # int32[B, N] action from parent
    # --- stored node board state (the reference keeps a Game copy along
    # each search path; here every node stores its position once at
    # creation so descents do NO board stepping — one step per sweep at
    # the leaf instead of one per level, the dominant search cost) ---
    s_stones: jnp.ndarray  # int8[B, N, 361]
    s_chain: jnp.ndarray  # int16[B, N, 361] chain ids (-1 empty)
    s_last5: jnp.ndarray  # int16[B, N, 5] last moves
    s_ko: jnp.ndarray  # int16[B, N] simple-ko point (-1 none)
    s_cpass: jnp.ndarray  # int8[B, N] consecutive passes
    s_hash: jnp.ndarray  # uint32[B, N, 2] zobrist lanes
    s_legal: jnp.ndarray  # bool[B, N, 362] legality for to-move at node
    # --- value-bias cache bookkeeping (bias_cache.h; mcts/bias.py):
    # the node's pattern slot/keys and its LAST contributed terms so
    # accumulation telescopes across searches under tree reuse ---
    bias_slot: jnp.ndarray  # int32[B, N] pattern table slot (-1 none)
    bias_k0: jnp.ndarray  # uint32[B, N]
    bias_k1: jnp.ndarray  # uint32[B, N]
    bias_obs_last: jnp.ndarray  # f32[B, N] last contributed err term
    bias_w_last: jnp.ndarray  # f32[B, N] last contributed weight term


def make_tree(batch_size: int, max_nodes: int) -> Tree:
    B, N = batch_size, max_nodes
    # `children` holds int16 node indices and `edge_n` int16 visit counts:
    # the shrink is only valid while indices fit (backprop saturates edge_n
    # at EDGE_N_MAX, but a wrapped child index would corrupt the tree).
    if max_nodes >= 2**15:
        raise ValueError(
            f"max_nodes={max_nodes} >= 2**15 would overflow int16 child "
            "indices (mcts/tree.py dtype shrink)")
    return Tree(
        n=jnp.zeros((B, N), jnp.int32),
        w=jnp.zeros((B, N), jnp.float32),
        w_outcome=jnp.zeros((B, N), jnp.float32),
        score_sum=jnp.zeros((B, N), jnp.float32),
        v_var_sum=jnp.zeros((B, N), jnp.float32),
        v_m3_sum=jnp.zeros((B, N), jnp.float32),
        vz_var_sum=jnp.zeros((B, N), jnp.float32),
        init_util=jnp.zeros((B, N), jnp.float32),
        init_outcome=jnp.zeros((B, N), jnp.float32),
        init_score=jnp.zeros((B, N), jnp.float32),
        init_err=jnp.zeros((B, N), jnp.float32),
        log_priors=jnp.zeros((B, N, NUM_MOVES), jnp.bfloat16),
        children=jnp.full((B, N, NUM_MOVES), NO_CHILD, jnp.int16),
        edge_n=jnp.zeros((B, N, NUM_MOVES), jnp.int16),
        edge_w=jnp.zeros((B, N, NUM_MOVES), jnp.float32),
        edge_wz=jnp.zeros((B, N, NUM_MOVES), jnp.float32),
        color=jnp.zeros((B, N), jnp.int8),
        is_terminal=jnp.zeros((B, N), jnp.bool_),
        evaluated=jnp.zeros((B, N), jnp.bool_),
        next_free=jnp.ones((B,), jnp.int32),  # slot 0 = root
        v_categorical=jnp.zeros((B, N, NUM_V_BUCKETS), jnp.int32),
        parent=jnp.full((B, N), -1, jnp.int32),
        parent_action=jnp.zeros((B, N), jnp.int32),
        s_stones=jnp.zeros((B, N, NUM_LOCS), jnp.int8),
        s_chain=jnp.full((B, N, NUM_LOCS), -1, jnp.int16),
        s_last5=jnp.full((B, N, 5), -1, jnp.int16),
        s_ko=jnp.full((B, N), -1, jnp.int16),
        s_cpass=jnp.zeros((B, N), jnp.int8),
        s_hash=jnp.zeros((B, N, 2), jnp.uint32),
        s_legal=jnp.zeros((B, N, NUM_MOVES), jnp.bool_),
        bias_slot=jnp.full((B, N), -1, jnp.int32),
        bias_k0=jnp.zeros((B, N), jnp.uint32),
        bias_k1=jnp.zeros((B, N), jnp.uint32),
        bias_obs_last=jnp.zeros((B, N), jnp.float32),
        bias_w_last=jnp.zeros((B, N), jnp.float32),
    )


def rows_by_node(arr: jnp.ndarray, node_bk: jnp.ndarray) -> jnp.ndarray:
    """Select per-node rows: arr [B, N, A] + node [B, k] -> [B, k, A].

    One-hot contraction over the (small) node axis instead of a generic
    per-row gather.
    """
    N = arr.shape[1]
    oh = jax.nn.one_hot(node_bk, N, dtype=jnp.float32)
    out = jnp.einsum("bkn,bna->bka", oh, arr.astype(jnp.float32),
                     preferred_element_type=jnp.float32)
    return out


def node_v(tree: Tree, node: jnp.ndarray) -> jnp.ndarray:
    """Mean utility of node [B] (own perspective); MIN_Q when unvisited."""
    b = jnp.arange(tree.n.shape[0])
    n = tree.n[b, node]
    return jnp.where(n > 0, tree.w[b, node] / jnp.maximum(n, 1), MIN_Q)


def q_nvis_of_children(tree: Tree, node_bk: jnp.ndarray):
    """Per-child Q and visit counts from edge stats.

    node_bk [B, k] -> (q [B, k, 362], nvis [B, k, 362]); Q = -edge_w/edge_n
    (sign flip, tree.h:118-123), MIN_Q where unvisited.
    """
    en = rows_by_node(tree.edge_n.astype(jnp.float32), node_bk)
    ew = rows_by_node(tree.edge_w, node_bk)
    nvis = en.astype(jnp.int32)
    q = jnp.where(nvis > 0, -(ew / jnp.maximum(en, 1.0)), MIN_Q)
    return q, nvis


def q_of_children(tree: Tree, node: jnp.ndarray,
                  bidx: jnp.ndarray = None) -> jnp.ndarray:
    """[W, 362] Q(node, a) (flat-lane convenience wrapper)."""
    q, _ = q_nvis_of_children(tree, node[:, None] if node.ndim == 1 else node)
    return q[:, 0] if node.ndim == 1 else q


def child_visits(tree: Tree, node: jnp.ndarray,
                 bidx: jnp.ndarray = None) -> jnp.ndarray:
    """[W, 362] visit counts of node's children (flat-lane wrapper)."""
    _, nvis = q_nvis_of_children(tree,
                                 node[:, None] if node.ndim == 1 else node)
    return nvis[:, 0] if node.ndim == 1 else nvis


# ---------------------------------------------------------------------------
# MCGS transposition table (McgsNodeTable, node_table.h:78-120): nodes keyed
# by (zobrist hash, color to move, is_terminal) so transposed positions share
# one node — the tree becomes a DAG whose node + out-edge statistics pool
# visits from every transposing path. Array mapping: a per-board
# open-addressed hash table probed with exact one-hot contractions (16-bit
# key halves are exact in f32).
#
# Deviations (documented): inserts are deferred to the end of each k-wide
# sweep, so two lanes reaching the same new position in one sweep create
# duplicate nodes (a missed share, not an error — the reference's mutex
# serializes these). Backprop stays incremental (the reference recomputes
# node stats from children under MCGS, gumbel.cc:772-777); node/edge stats
# remain exact visit sums, but ancestors do not see sibling-path updates.
# ---------------------------------------------------------------------------

MCGS_PROBES = 4


class McgsTable(NamedTuple):
    """Open-addressed per-board node table [B, S] (S = power of two)."""

    key0: jnp.ndarray  # uint32[B, S] zobrist lane 0
    key1: jnp.ndarray  # uint32[B, S] zobrist lane 1
    meta: jnp.ndarray  # int8[B, S]: 0 empty, else color * (1 + is_terminal)
    node: jnp.ndarray  # int32[B, S] node slot index


def make_mcgs_table(batch_size: int, size: int) -> McgsTable:
    assert size & (size - 1) == 0, "table size must be a power of two"
    return McgsTable(
        key0=jnp.zeros((batch_size, size), jnp.uint32),
        key1=jnp.zeros((batch_size, size), jnp.uint32),
        meta=jnp.zeros((batch_size, size), jnp.int8),
        node=jnp.zeros((batch_size, size), jnp.int32),
    )


def mcgs_meta(color: jnp.ndarray, is_terminal: jnp.ndarray) -> jnp.ndarray:
    """Key tag: color in {1,-1} x (1 + terminal) -> {1,-1,2,-2}; 0 = empty."""
    return (color.astype(jnp.int8)
            * (1 + is_terminal.astype(jnp.int8))).astype(jnp.int8)


def _mcgs_slots(h0: jnp.ndarray, h1: jnp.ndarray, size: int) -> jnp.ndarray:
    """[W, P] linear probe sequence from the 2-lane hash."""
    base = (h0 ^ (h1 * jnp.uint32(2654435761))).astype(jnp.uint32)
    offs = jnp.arange(MCGS_PROBES, dtype=jnp.uint32)[None, :]
    return ((base[:, None] + offs) & jnp.uint32(size - 1)).astype(jnp.int32)


def mcgs_probe(table: McgsTable, k_r: int, h0: jnp.ndarray, h1: jnp.ndarray,
               meta_q: jnp.ndarray):
    """Lookup (hash, meta) for W = B * k_r lanes (lanes b-major).

    Returns (hit [W] bool, node [W] int32, ins_slot [W] int32,
    has_empty [W] bool); ins_slot is the first empty probed slot for a
    subsequent insert.
    """
    B, S = table.key0.shape
    W = h0.shape[0]
    slots = _mcgs_slots(h0, h1, S)  # [W, P]
    oh = jax.nn.one_hot(slots, S, dtype=jnp.float32).reshape(
        B, k_r * MCGS_PROBES, S)  # [B, kP, S]
    gsel = lambda arr: jnp.einsum(
        "bps,bs->bp", oh, arr.astype(jnp.float32),
        preferred_element_type=jnp.float32).reshape(W, MCGS_PROBES)
    # 16-bit halves are exact in f32; one-hot selection keeps them exact.
    g_k0lo = gsel(table.key0 & jnp.uint32(0xFFFF))
    g_k0hi = gsel(table.key0 >> jnp.uint32(16))
    g_k1lo = gsel(table.key1 & jnp.uint32(0xFFFF))
    g_k1hi = gsel(table.key1 >> jnp.uint32(16))
    g_meta = gsel(table.meta)
    g_node = gsel(table.node)

    q_k0lo = (h0 & jnp.uint32(0xFFFF)).astype(jnp.float32)[:, None]
    q_k0hi = (h0 >> jnp.uint32(16)).astype(jnp.float32)[:, None]
    q_k1lo = (h1 & jnp.uint32(0xFFFF)).astype(jnp.float32)[:, None]
    q_k1hi = (h1 >> jnp.uint32(16)).astype(jnp.float32)[:, None]
    q_meta = meta_q.astype(jnp.float32)[:, None]

    hit_p = ((g_meta == q_meta) & (g_meta != 0.0)
             & (g_k0lo == q_k0lo) & (g_k0hi == q_k0hi)
             & (g_k1lo == q_k1lo) & (g_k1hi == q_k1hi))  # [W, P]
    first_hit = hit_p & (jnp.cumsum(hit_p, axis=1) == 1)
    hit = jnp.any(hit_p, axis=1)
    node = jnp.sum(jnp.where(first_hit, g_node, 0.0),
                   axis=1).astype(jnp.int32)

    empty_p = g_meta == 0.0
    first_empty = empty_p & (jnp.cumsum(empty_p, axis=1) == 1)
    has_empty = jnp.any(empty_p, axis=1)
    ins_slot = jnp.sum(jnp.where(first_empty, slots, 0), axis=1)
    return hit, node, ins_slot, has_empty


def mcgs_insert(table: McgsTable, k_r: int, slot: jnp.ndarray,
                h0: jnp.ndarray, h1: jnp.ndarray, meta: jnp.ndarray,
                node: jnp.ndarray, do: jnp.ndarray) -> McgsTable:
    """Scatter-insert W lane entries; `do`=False lanes are dropped. Slot
    collisions across lanes keep one arbitrary winner (missed share)."""
    B, S = table.key0.shape
    W = slot.shape[0]
    bw = jnp.arange(W) // k_r
    s = jnp.where(do, slot, S)  # out-of-bounds -> dropped
    return McgsTable(
        key0=table.key0.at[bw, s].set(h0, mode="drop"),
        key1=table.key1.at[bw, s].set(h1, mode="drop"),
        meta=table.meta.at[bw, s].set(meta, mode="drop"),
        node=table.node.at[bw, s].set(node, mode="drop"),
    )


def welford_m3_delta(q, v_old, n_new, m2_old, dvar):
    """Pébay online third-central-moment increment.

    For one new observation q at a node with pre-update mean v_old, count
    n_new = n_old + 1, and accumulated M2 m2_old (= v_var_sum), given the
    matching M2 increment dvar = (q - v_old)(q - v_new):

        delta_n = (q - v_old) / n_new
        dM3 = dvar * delta_n * (n_new - 2) - 3 * delta_n * m2_old

    so that sum over a sequence of updates reproduces
    n * M3 = sum_i (x_i - mean)^3 exactly. Inputs broadcast; callers mask
    leaf slots like they do for dvar.
    """
    safe_n = jnp.maximum(n_new, 1.0)
    delta_n = (q - v_old) / safe_n
    return dvar * delta_n * (n_new - 2.0) - 3.0 * delta_n * m2_old


def compact_subtree(tree: Tree, action: jnp.ndarray, capacity: int) -> Tree:
    """Extract the subtree under root's child `action` into a fresh tree.

    Replaces NodeTable::Reap + tree reuse (node_table.h Reap, selfplay tree
    reuse self_play_thread.cc:709-727): after a real move, the selected
    child becomes the next search's root with its statistics intact.

    Works in allocation order (children always have higher slot indices
    than parents), so reachability is one sequential scan over node slots
    and every copy is a one-hot contraction. The child table is REBUILT
    from compacted (parent, action) pairs instead of value-remapping the
    [B, N, 362] pointer array (which costs N passes over it). Boards whose
    chosen action has no child get an empty (unevaluated) tree.
    """
    B = tree.n.shape[0]
    b = jnp.arange(B)
    new_root = tree.children[b, jnp.zeros((B,), jnp.int32), action]  # [B]
    return _compact(tree, new_root, capacity)


def compact_root(tree: Tree, capacity: int) -> Tree:
    """Compact the WHOLE tree (root stays root) into `capacity` slots.

    Used to re-feed an accumulated working tree as the next search's
    init_tree at a fixed static capacity (GTP pondering keeps searching
    the same root across batches, service.cc:677-705); nodes beyond
    capacity are dropped in allocation order.

    The root is never on a backprop path (only stitching touches it), so
    its node stats are RECONSTRUCTED from its out-edges here:
    n = 1 + sum(edge_n), w = init_util - sum(edge_w) (edge sums are in the
    child's perspective), likewise w_outcome — keeping the
    sum_children == n-1 invariant the improved policy relies on.
    """
    B = tree.n.shape[0]
    out = _compact(tree, jnp.zeros((B,), jnp.int32), capacity)
    ev = out.evaluated[:, 0]
    en = out.edge_n[:, 0, :].astype(jnp.float32)
    n0 = 1 + jnp.sum(en, axis=-1).astype(jnp.int32)
    w0 = out.init_util[:, 0] - jnp.sum(out.edge_w[:, 0, :], axis=-1)
    wz0 = out.init_outcome[:, 0] - jnp.sum(out.edge_wz[:, 0, :], axis=-1)
    return out._replace(
        n=out.n.at[:, 0].set(jnp.where(ev, n0, out.n[:, 0])),
        w=out.w.at[:, 0].set(jnp.where(ev, w0, out.w[:, 0])),
        w_outcome=out.w_outcome.at[:, 0].set(
            jnp.where(ev, wz0, out.w_outcome[:, 0])),
    )


def _compact(tree: Tree, new_root: jnp.ndarray, capacity: int) -> Tree:
    B, N = tree.n.shape
    b = jnp.arange(B)

    # reachable[m] = (m == new_root) | reachable[parent[m]]
    def scan_body(reach, m):
        par = tree.parent[b, m]
        par_reach = jnp.take_along_axis(
            reach, jnp.clip(par, 0, N - 1)[:, None], axis=1)[:, 0]
        r = (m == new_root) | (par_reach & (par >= 0))
        reach = reach.at[:, m].set(r)
        return reach, None

    reach0 = jnp.zeros((B, N), jnp.bool_)
    reachable, _ = jax.lax.scan(scan_body, reach0,
                                jnp.arange(N, dtype=jnp.int32))

    new_idx = jnp.where(reachable, jnp.cumsum(reachable, axis=1) - 1, -1)
    num = jnp.sum(reachable, axis=1).astype(jnp.int32)

    # One-hot selection matrix [B, capacity, N]: row r takes old slot m.
    sel = jax.nn.one_hot(
        jnp.where(reachable, new_idx, capacity), capacity,
        dtype=jnp.float32, axis=-1).transpose(0, 2, 1)  # [B, cap, N]

    def rows(arr):
        if arr.ndim == 2:
            out = jnp.einsum("bcm,bm->bc", sel, arr.astype(jnp.float32))
        else:
            out = jnp.einsum("bcm,bma->bca", sel, arr.astype(jnp.float32))
        return out.astype(arr.dtype)

    # Parent remap over the small [B, cap] array (new root's parent -> -1).
    parent_rows = rows(jnp.where(tree.parent < 0, N, tree.parent))
    parent_new = jnp.full((B, capacity), -1, jnp.int32)
    for m in range(N):
        nm = new_idx[:, m][:, None]
        parent_new = jnp.where((parent_rows == m) & (nm >= 0), nm, parent_new)
    action_rows = rows(tree.parent_action)
    compact_reach = rows(reachable.astype(jnp.int32)) > 0  # [B, cap]
    # the new root (slot 0) has no parent
    parent_new = parent_new.at[:, 0].set(-1)

    # Rebuild children from (parent_new, action) of nodes 1..cap-1.
    is_child = compact_reach & (jnp.arange(capacity)[None, :] > 0)
    oh_p = jax.nn.one_hot(
        jnp.where(is_child, parent_new, capacity), capacity,
        dtype=jnp.float32)  # [B, cap(r), cap(p)]
    oh_a = jax.nn.one_hot(
        jnp.where(is_child, action_rows, NUM_MOVES), NUM_MOVES,
        dtype=jnp.float32)  # [B, cap(r), 362]
    r_ids = jnp.arange(capacity, dtype=jnp.float32)[None, :, None]
    counts = jnp.einsum("brp,bra->bpa", oh_p, oh_a,
                        preferred_element_type=jnp.float32)
    vals = jnp.einsum("brp,bra->bpa", oh_p * r_ids, oh_a,
                      preferred_element_type=jnp.float32)
    children_new = jnp.where(counts > 0, vals, -1.0).astype(
        tree.children.dtype)

    out = make_tree(B, capacity)
    out = out._replace(
        n=rows(tree.n),
        w=rows(tree.w),
        w_outcome=rows(tree.w_outcome),
        score_sum=rows(tree.score_sum),
        v_var_sum=rows(tree.v_var_sum),
        vz_var_sum=rows(tree.vz_var_sum),
        v_m3_sum=rows(tree.v_m3_sum),
        init_util=rows(tree.init_util),
        init_outcome=rows(tree.init_outcome),
        init_score=rows(tree.init_score),
        init_err=rows(tree.init_err),
        log_priors=rows(tree.log_priors),
        children=children_new,
        edge_n=rows(tree.edge_n),
        edge_w=rows(tree.edge_w),
        edge_wz=rows(tree.edge_wz),
        color=rows(tree.color),
        is_terminal=rows(tree.is_terminal.astype(jnp.int32)).astype(jnp.bool_),
        evaluated=rows(tree.evaluated.astype(jnp.int32)).astype(jnp.bool_),
        # Clamp to capacity: when the reachable subtree exceeds `capacity`
        # (deep reused lines), nodes past capacity are dropped by the
        # one-hot above, and the allocation cursor must not point past the
        # array or subsequent searches would scatter out of bounds /
        # corrupt the spare slot.
        next_free=jnp.clip(num, 1, capacity),
        v_categorical=rows(tree.v_categorical),
        parent=parent_new,
        parent_action=jnp.where(compact_reach, action_rows, 0),
        s_stones=rows(tree.s_stones),
        s_chain=rows(tree.s_chain),
        s_last5=rows(tree.s_last5),
        s_ko=rows(tree.s_ko),
        s_cpass=rows(tree.s_cpass),
        # uint32 hashes are not exact in f32: select the 16-bit halves
        # separately (exact) and reassemble.
        s_hash=(
            (rows((tree.s_hash >> jnp.uint32(16)).astype(jnp.int32))
             .astype(jnp.uint32) << jnp.uint32(16))
            | rows((tree.s_hash & jnp.uint32(0xFFFF)).astype(jnp.int32))
            .astype(jnp.uint32)),
        s_legal=rows(tree.s_legal.astype(jnp.int32)).astype(jnp.bool_),
        # unreachable rows must read slot -1, not 0
        bias_slot=jnp.where(compact_reach, rows(tree.bias_slot), -1),
        bias_k0=(
            (rows((tree.bias_k0 >> jnp.uint32(16)).astype(jnp.int32))
             .astype(jnp.uint32) << jnp.uint32(16))
            | rows((tree.bias_k0 & jnp.uint32(0xFFFF)).astype(jnp.int32))
            .astype(jnp.uint32)),
        bias_k1=(
            (rows((tree.bias_k1 >> jnp.uint32(16)).astype(jnp.int32))
             .astype(jnp.uint32) << jnp.uint32(16))
            | rows((tree.bias_k1 & jnp.uint32(0xFFFF)).astype(jnp.int32))
            .astype(jnp.uint32)),
        bias_obs_last=rows(tree.bias_obs_last),
        bias_w_last=rows(tree.bias_w_last),
    )
    return out
