"""Explicitly sharded genotype operator (shard_map over the (task, snp) mesh).

Auto-sharding (jit + sharding annotations) partitions the XLA decode path
fine, but the fused score kernel is an opaque custom call to the SPMD
partitioner — it would force an all-gather of the packed matrix. This module
re-expresses each operator product with `shard_map` so the kernel runs *per
shard* with explicit collectives:

  * ``xtr`` (score X'R): SNP rows are owned by their shard — zero
    communication (the reference's thread-local column loops,
    src/utilities.jl:96-106, had the same structure);
  * ``forward_sel`` (k-sparse X[:, idx] @ coef): each shard contributes the
    selected columns it owns, then one psum over the 'snp' axis (the
    reference's `sum!` reduction over per-thread accumulators);
  * ``col_moments`` / ``gather_cols``: local + psum like the above.

The 'task' axis shards the batch (cross-validation (fold, k) combinations)
and never communicates.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
try:
    from jax import shard_map                      # jax >= 0.4.35
except ImportError:                                # pragma: no cover
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import decode
from ..ops.linalg import PackedOp
from ..ops.projections import fast_top_k
from ..genotype.snparray import PackedGenotypes


def _local_slice(idx, p_local):
    """Per-shard ownership mask + local indices for global SNP ids (must be
    called inside shard_map; p_local is the shard's row count)."""
    off = jax.lax.axis_index("snp") * p_local
    lidx = idx - off
    owned = (lidx >= 0) & (lidx < p_local)
    return jnp.where(owned, lidx, 0), owned


def _local_xt_dots(words, R, want_missing, p_local, want_sq=False):
    """Full-width raw dots on a local (p4_local, n4) quad-word shard;
    outputs have leading dim p_local (= 4*p4_local SNPs, quad-padding rows
    sliced off when the true shard row count is smaller).

    The shard_maps that call this run with ``check_vma=False``: a
    pallas_call's outputs carry no varying-mesh-axes annotation, which the
    check requires."""
    from ..ops import linalg as _lin
    if _lin.use_kernel():
        from ..ops import score_kernel
        return score_kernel.xt_dots_words(words, R.T,
                                          want_missing=want_missing,
                                          want_sq=want_sq, p=p_local)
    p4, n4 = words.shape
    by = jax.lax.bitcast_convert_type(words, jnp.uint8)      # (p4, n4, 4)
    packed = jnp.transpose(by, (0, 2, 1)).reshape(4 * p4, n4)[:p_local]
    return decode.xt_dots(packed, R.T, want_missing=want_missing,
                          want_sq=want_sq)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class ShardedPackedOp:
    """Drop-in PackedOp whose products are shard_map'ed over `mesh`.

    `geno` holds globally-shaped arrays placed with the canonical shardings
    (packed/mu/inv_sd split along 'snp'); batch inputs are expected sharded
    (or shardable) along 'task'."""
    geno: PackedGenotypes
    mesh: Mesh

    def tree_flatten(self):
        return (self.geno,), (self.mesh,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], aux[0])

    # -- shape properties mirror PackedOp --------------------------------
    @property
    def n(self):
        return self.geno.n

    @property
    def p(self):
        return self.geno.p

    @property
    def n_pad(self):
        return self.geno.n_pad

    @property
    def dtype(self):
        return self.geno.mu.dtype

    # ---------------------------------------------------------------------
    def xtr(self, R: jnp.ndarray) -> jnp.ndarray:
        g = self.geno

        def local(words, mu, inv_sd, R):
            A, M, _ = _local_xt_dots(words, R, g.has_missing, mu.shape[0])
            colsum = jnp.sum(R, axis=1)
            corr = M - colsum[None, :] if g.has_missing else -colsum[None, :]
            return (inv_sd[:, None] * (A + mu[:, None] * corr)).T

        f = shard_map(
            local, mesh=self.mesh,
            in_specs=(P("snp", None), P("snp"), P("snp"), P("task", None)),
            out_specs=P("task", "snp"), check_vma=False)
        return f(g.words, g.mu, g.inv_sd, R)


    def forward_sel(self, idx, coef, valid):
        g = self.geno

        def local(words, mu, inv_sd, idx, coef, valid):
            lidx, owned = _local_slice(idx, mu.shape[0])
            sel = valid * owned.astype(coef.dtype)
            coef_s = coef * inv_sd[lidx] * sel
            rows = decode.take_rows_bytes(words, lidx)
            raw = decode.sparse_forward_rows(rows, lidx, coef_s, mu,
                                             want_missing=g.has_missing)
            const = jnp.sum(coef_s * mu[lidx], axis=1)
            return jax.lax.psum(raw - const[:, None], "snp")

        f = shard_map(
            local, mesh=self.mesh,
            in_specs=(P("snp", None), P("snp"), P("snp"),
                      P("task", None), P("task", None), P("task", None)),
            out_specs=P("task", None))
        return f(g.words, g.mu, g.inv_sd, idx, coef,
                 valid.astype(coef.dtype))

    def forward_sel_multi(self, idx, coef, valid):
        g = self.geno

        def local(words, mu, inv_sd, idx, coef, valid):
            lidx, owned = _local_slice(idx, mu.shape[0])
            sel = valid * owned.astype(coef.dtype)
            coef_s = coef * (inv_sd[lidx] * sel)[:, None, :]
            rows = decode.take_rows_bytes(words, lidx)
            raw = decode.sparse_forward_rows_multi(rows, lidx, coef_s, mu,
                                                   want_missing=g.has_missing)
            const = jnp.sum(coef_s * mu[lidx][:, None, :], axis=2)
            return jax.lax.psum(raw - const[:, :, None], "snp")

        f = shard_map(
            local, mesh=self.mesh,
            in_specs=(P("snp", None), P("snp"), P("snp"),
                      P("task", None), P("task", None, None), P("task", None)),
            out_specs=P("task", None, None))
        return f(g.words, g.mu, g.inv_sd, idx, coef,
                 valid.astype(coef.dtype))

    def gather_cols(self, idx, valid):
        g = self.geno
        dtype = self.dtype

        def local(words, mu, inv_sd, idx, valid):
            lidx, owned = _local_slice(idx, mu.shape[0])
            rows = decode.take_rows_bytes(words, lidx)
            val, miss = decode.gather_decode_rows(rows, dtype,
                                                  want_missing=g.has_missing)
            mu_s = mu[lidx][:, :, None]
            inv = inv_sd[lidx][:, :, None]
            if g.has_missing:
                val = val + mu_s * miss
            out = (val - mu_s) * inv
            sel = (valid * owned.astype(dtype))[:, :, None]
            return jax.lax.psum(out * sel, "snp")

        f = shard_map(
            local, mesh=self.mesh,
            in_specs=(P("snp", None), P("snp"), P("snp"),
                      P("task", None), P("task", None)),
            out_specs=P("task", None, None))
        return f(g.words, g.mu, g.inv_sd, idx, valid.astype(dtype))

    # --- support primitives: exchange (B, S) candidates, never (B, p) -----
    # Without these the solver's global take_along_axis / top_k on the
    # sharded (B, p) arrays make XLA ALL-GATHER the full array every
    # iteration (4 x 10.5 MB/iter at p = 131k on 8 virtual CPU shards,
    # tools/comm_check.py) — at UKB scale that is ~160 MB/iter of
    # interconnect traffic. The two-stage forms below are the "per-shard top-k ->
    # gather candidates -> global top-k" design from SURVEY.md §5.

    def take_b(self, arr, gidx, gval):
        """Masked (B, S) gather from a SNP-sharded (B, p) array: each shard
        contributes the entries it owns; one small psum."""
        def local(a_l, gidx, gval):
            lidx, owned = _local_slice(gidx, a_l.shape[1])
            v = jnp.take_along_axis(a_l, lidx, axis=1)
            v = jnp.where(owned & gval, v, jnp.zeros((), v.dtype))
            return jax.lax.psum(v, "snp")

        f = shard_map(
            local, mesh=self.mesh,
            in_specs=(P("task", "snp"), P("task", None), P("task", None)),
            out_specs=P("task", None))
        return f(arr, gidx, gval)

    def _candidates(self, b, c, zkeep, S, weight):
        """Two-stage top-S over the sharded joint [b; c]: per-shard top-S
        candidates -> all_gather (B, ns*S + q) -> global top-S.  Returns
        (sel_idx (B,S) global [b;c] indices, vals (B,S) original values)."""
        from ..ops.projections import fast_top_k
        p = self.p

        def local(b_l, c_l, zkeep, w):
            B, p_local = b_l.shape
            q = c_l.shape[1]
            off = jax.lax.axis_index("snp") * p_local
            magb = jnp.abs(b_l)
            if w is not None:
                wb = jax.lax.dynamic_slice(w, (off,), (p_local,))
                magb = magb * wb[None, :]
            Sl = min(S, p_local)
            v, i = fast_top_k(magb, Sl)
            xv = jnp.take_along_axis(b_l, i, axis=1)
            cand_v = jax.lax.all_gather(v, "snp", axis=1, tiled=True)
            cand_i = jax.lax.all_gather(i + off, "snp", axis=1, tiled=True)
            cand_x = jax.lax.all_gather(xv, "snp", axis=1, tiled=True)
            magc = jnp.abs(c_l)
            if w is not None:
                magc = magc * w[p:][None, :]
            magc = jnp.where(zkeep[None, :], jnp.inf, magc)
            cat_v = jnp.concatenate([cand_v, magc], axis=1)
            cat_i = jnp.concatenate(
                [cand_i, jnp.broadcast_to(p + jnp.arange(q, dtype=cand_i.dtype
                                                         )[None, :], (B, q))],
                axis=1)
            cat_x = jnp.concatenate([cand_x, c_l], axis=1)
            _, sel = jax.lax.top_k(cat_v, S)
            sel_idx = jnp.take_along_axis(cat_i, sel, axis=1)
            vals = jnp.take_along_axis(cat_x, sel, axis=1)
            return sel_idx, vals

        specs = [P("task", "snp"), P("task", None), P()]
        args = [b, c, zkeep]
        if weight is not None:
            specs.append(P())
            args.append(weight)
            fn = lambda b_l, c_l, zk, w: local(b_l, c_l, zk, w)
        else:
            fn = lambda b_l, c_l, zk: local(b_l, c_l, zk, None)
        # the all_gather makes both outputs bitwise-replicated over 'snp';
        # shard_map cannot infer that statically -> disable the check
        f = shard_map(fn, mesh=self.mesh, in_specs=tuple(specs),
                      out_specs=(P("task", None), P("task", None)),
                      check_vma=False)
        return f(*args)

    def select_support(self, b, c, zkeep, S):
        sel_idx, vals = self._candidates(b, c, zkeep, S, None)
        return sel_idx, vals != 0

    def project_topk_joint(self, b, c, k_plus_keep, zkeep, S, weight=None):
        """Sharded joint top-k projection (ops/projections.project_topk_joint
        semantics): zero everything but each task's k_plus_keep largest
        entries; zkeep covariates keep their value unconditionally."""
        p = self.p
        sel_idx, vals = self._candidates(b, c, zkeep, S, weight)
        keep = jnp.arange(S)[None, :] < k_plus_keep[:, None]
        kept = jnp.where(keep, vals, jnp.zeros((), vals.dtype))

        def scatter_b(b_l, sel_idx, kept):
            B, p_local = b_l.shape
            off = jax.lax.axis_index("snp") * p_local
            lsel = sel_idx - off
            owned = (lsel >= 0) & (lsel < p_local)
            return jnp.zeros_like(b_l).at[
                jnp.arange(B)[:, None], jnp.where(owned, lsel, 0)
            ].add(jnp.where(owned, kept, jnp.zeros((), kept.dtype)))

        f = shard_map(
            scatter_b, mesh=self.mesh,
            in_specs=(P("task", "snp"), P("task", None), P("task", None)),
            out_specs=P("task", "snp"))
        b_new = f(b, sel_idx, kept)
        q = c.shape[1]
        is_c = sel_idx >= p
        c_new = jnp.zeros_like(c).at[
            jnp.arange(c.shape[0])[:, None],
            jnp.where(is_c, sel_idx - p, 0)
        ].add(jnp.where(is_c, kept, jnp.zeros((), kept.dtype)))
        c_new = jnp.where(zkeep[None, :], c, c_new)
        sel_keep = keep & (vals != 0)
        return b_new, c_new, sel_idx, vals, sel_keep

    # --- group (doubly-sparse) projection ---------------------------------
    def project_group_sparse(self, b1, group, J: int, ks, k_task,
                             n_groups: int, cand: int):
        """Sharded doubly-sparse projection (reference project_group_sparse!,
        src/utilities.jl:613-679): per-shard group-local top-k -> bounded
        (B, cand) candidate exchange -> replicated global projection over
        candidates -> owned scatter.  Exact: every global survivor also
        survives its shard-local per-group top-k, and `cand`
        (cfg.group_cand, clamped to p_local) bounds the local survivor
        count, so the candidate union always contains the global support.
        The (B, p) array never leaves its shards (the same reconciliation
        that caught the top-k all-gather, tools/comm_check.py).

        ``ks`` (n_groups,) per-group caps is used when k_task is None;
        otherwise every group's cap is the task's own scalar ``k_task`` (B,)
        (reference v.k semantics, src/utilities.jl:255)."""
        from ..ops.projections import _group_sparse_one, fast_top_k
        p = self.p

        def local(b_l, group, ks, k_task):
            B, p_local = b_l.shape
            off = jax.lax.axis_index("snp") * p_local
            group0 = jax.lax.dynamic_slice(
                (group - 1).astype(jnp.int32), (off,), (p_local,))
            Sg = min(max(cand, 1), p_local)

            def one_local(v, ksg):
                # group-local top-k only: J = n_groups disables group choice
                return _group_sparse_one(v, group0, ksg, n_groups, n_groups)

            if k_task is None:
                v_loc = jax.vmap(lambda v: one_local(v, ks))(b_l)
            else:
                v_loc = jax.vmap(lambda v, kt: one_local(
                    v, jnp.broadcast_to(kt, (n_groups,))))(b_l, k_task)
            vals, lidx = fast_top_k(jnp.abs(v_loc), Sg)
            xv = jnp.take_along_axis(v_loc, lidx, axis=1)
            g_cand = group0[lidx]                          # (B, Sg)
            cat_x = jax.lax.all_gather(xv, "snp", axis=1, tiled=True)
            cat_i = jax.lax.all_gather(lidx + off, "snp", axis=1, tiled=True)
            cat_g = jax.lax.all_gather(g_cand, "snp", axis=1, tiled=True)

            def one_global(xv, gv, ksg):
                return _group_sparse_one(xv, gv, ksg, J, n_groups)

            if k_task is None:
                kept = jax.vmap(lambda xv, gv: one_global(xv, gv, ks))(
                    cat_x, cat_g)
            else:
                kept = jax.vmap(lambda xv, gv, kt: one_global(
                    xv, gv, jnp.broadcast_to(kt, (n_groups,))))(
                    cat_x, cat_g, k_task)
            lsel = cat_i - off
            owned = (lsel >= 0) & (lsel < p_local)
            return jnp.zeros_like(b_l).at[
                jnp.arange(B)[:, None], jnp.where(owned, lsel, 0)
            ].add(jnp.where(owned, kept, jnp.zeros((), kept.dtype)))

        specs = [P("task", "snp"), P(), P()]
        args = [b1, jnp.asarray(group), jnp.asarray(ks, jnp.int32)]
        if k_task is None:
            fn = lambda b_l, g, ks: local(b_l, g, ks, None)
        else:
            specs.append(P("task"))
            args.append(jnp.asarray(k_task, jnp.int32))
            fn = lambda b_l, g, ks, kt: local(b_l, g, ks, kt)
        f = shard_map(fn, mesh=self.mesh, in_specs=tuple(specs),
                      out_specs=P("task", "snp"), check_vma=False)
        return f(*args)

    # --- multivariate products (reference src/multivariate.jl:66-92) -------
    # The mv score reshapes (T, r, n_pad) -> (T*r, n_pad) before X'R; doing
    # that reshape OUTSIDE shard_map breaks the task-axis contract (T*r rows
    # are only task-aligned inside a shard), so these run it per shard.

    def xtr_multi(self, GR: jnp.ndarray) -> jnp.ndarray:
        """(T, r, n_pad) -> (T, r, p): the mv score df = (Gamma R) X' with
        the trait axis riding the RHS batch inside each shard."""
        g = self.geno

        def local(words, mu, inv_sd, GR):
            T_l, r, n_pad = GR.shape
            A, M, _ = _local_xt_dots(words, GR.reshape(T_l * r, n_pad),
                                     g.has_missing, mu.shape[0])
            colsum = jnp.sum(GR, axis=2).reshape(T_l * r)
            corr = M - colsum[None, :] if g.has_missing else -colsum[None, :]
            out = (inv_sd[:, None] * (A + mu[:, None] * corr)).T
            return out.reshape(T_l, r, -1)

        f = shard_map(
            local, mesh=self.mesh,
            in_specs=(P("snp", None), P("snp"), P("snp"), P("task", None, None)),
            out_specs=P("task", None, "snp"), check_vma=False)
        return f(g.words, g.mu, g.inv_sd, GR)

    def take_b_multi(self, arr, gidx, gval):
        """Masked (T, r, S) gather from a SNP-sharded (T, r, p) array."""
        def local(a_l, gidx, gval):
            lidx, owned = _local_slice(gidx, a_l.shape[2])
            v = jnp.take_along_axis(
                a_l, lidx[:, None, :].repeat(a_l.shape[1], 1), axis=2)
            keep = (owned & gval)[:, None, :]
            v = jnp.where(keep, v, jnp.zeros((), v.dtype))
            return jax.lax.psum(v, "snp")

        f = shard_map(
            local, mesh=self.mesh,
            in_specs=(P("task", None, "snp"), P("task", None), P("task", None)),
            out_specs=P("task", None, None))
        return f(arr, gidx, gval)

    def project_joint_mv(self, Bm, Cm, k_plus_keep, zkeep, S_entries: int):
        """Sharded mv entry-level projection (mv._project_joint_mv semantics,
        reference project_k! src/multivariate.jl:108-127): two-stage top-k
        over the trait-major flattened [vec(B); vec(C)] — per-shard top-S
        candidates over the local (r, p_local) block, one (T, ns*S + r*q)
        candidate exchange, never a gather of the (T, r, p) tensor."""
        p = self.p
        T, r, _ = Bm.shape
        q = Cm.shape[2]

        def local(B_l, C_l, kpk, zk):
            T_l, r, p_local = B_l.shape
            off = jax.lax.axis_index("snp") * p_local
            flatB = B_l.reshape(T_l, r * p_local)
            Sl = min(S_entries, r * p_local)
            v, i = fast_top_k(jnp.abs(flatB), Sl)
            xv = jnp.take_along_axis(flatB, i, axis=1)
            # local flat (trait j, col loc) -> global flat j*p + off + loc
            gi = (i // p_local) * p + off + (i % p_local)
            cand_v = jax.lax.all_gather(v, "snp", axis=1, tiled=True)
            cand_i = jax.lax.all_gather(gi, "snp", axis=1, tiled=True)
            cand_x = jax.lax.all_gather(xv, "snp", axis=1, tiled=True)
            flatC = C_l.reshape(T_l, r * q)
            pin_c = jnp.tile(zk, r)
            magc = jnp.where(pin_c[None, :], jnp.inf, jnp.abs(flatC))
            cat_v = jnp.concatenate([cand_v, magc], axis=1)
            cat_i = jnp.concatenate(
                [cand_i, jnp.broadcast_to(
                    r * p + jnp.arange(r * q, dtype=cand_i.dtype)[None, :],
                    (T_l, r * q))], axis=1)
            cat_x = jnp.concatenate([cand_x, flatC], axis=1)
            _, sel = jax.lax.top_k(cat_v, S_entries)
            sel_idx = jnp.take_along_axis(cat_i, sel, axis=1)
            vals = jnp.take_along_axis(cat_x, sel, axis=1)
            keep = jnp.arange(S_entries)[None, :] < kpk[:, None]
            kept = jnp.where(keep, vals, jnp.zeros((), vals.dtype))
            # scatter owned B entries
            tr = sel_idx // p          # trait for B entries (< r when B)
            col = sel_idx % p
            is_b = sel_idx < r * p
            lcol = col - off
            owned = is_b & (lcol >= 0) & (lcol < p_local)
            lflat = jnp.where(owned, tr * p_local + lcol, 0)
            B_new = jnp.zeros_like(flatB).at[
                jnp.arange(T_l)[:, None], lflat
            ].add(jnp.where(owned, kept, jnp.zeros((), kept.dtype)))
            # C entries are replicated over 'snp'
            cflat = jnp.where(~is_b, sel_idx - r * p, 0)
            C_new = jnp.zeros_like(flatC).at[
                jnp.arange(T_l)[:, None], cflat
            ].add(jnp.where(~is_b, kept, jnp.zeros((), kept.dtype)))
            C_new = jnp.where(pin_c[None, :], flatC, C_new)
            return (B_new.reshape(T_l, r, p_local),
                    C_new.reshape(T_l, r, q))

        f = shard_map(
            local, mesh=self.mesh,
            in_specs=(P("task", None, "snp"), P("task", None, None),
                      P("task"), P()),
            out_specs=(P("task", None, "snp"), P("task", None, None)),
            check_vma=False)
        return f(Bm, Cm, k_plus_keep, zkeep)

    def column_support_mv(self, Bm, S: int):
        """Sharded mv column support: top-S SNP columns by max |B| over
        traits (mv._column_support semantics), via per-shard top-S candidate
        exchange."""
        def local(B_l):
            T_l, r, p_local = B_l.shape
            off = jax.lax.axis_index("snp") * p_local
            colmag = jnp.max(jnp.abs(B_l), axis=1)          # (T_l, p_local)
            Sl = min(S, p_local)
            v, i = fast_top_k(colmag, Sl)
            cand_v = jax.lax.all_gather(v, "snp", axis=1, tiled=True)
            cand_i = jax.lax.all_gather(i + off, "snp", axis=1, tiled=True)
            vals, sel = jax.lax.top_k(cand_v, S)
            sel_idx = jnp.take_along_axis(cand_i, sel, axis=1)
            return sel_idx, vals != 0

        f = shard_map(
            local, mesh=self.mesh,
            in_specs=(P("task", None, "snp"),),
            out_specs=(P("task", None), P("task", None)),
            check_vma=False)
        return f(Bm)

    def col_moments(self, W, WY):
        g = self.geno

        def local(words, mu, inv_sd, W, WY):
            B = W.shape[0]
            R = jnp.stack([W, WY], axis=0).reshape(2 * B, -1)
            A, M, Sq = _local_xt_dots(words, R, g.has_missing, mu.shape[0],
                                      want_sq=True)
            A = A.T.reshape(2, B, -1)
            Sq = Sq.T.reshape(2, B, -1)
            if g.has_missing:
                M = M.T.reshape(2, B, -1)
            else:
                M = jnp.zeros_like(A)
            mu_, inv = mu[None, :], inv_sd[None, :]
            sumW = jnp.sum(W, axis=1)[:, None]
            sumWY = jnp.sum(WY, axis=1)[:, None]
            Sx = inv * (A[0] + mu_ * (M[0] - sumW))
            Sxy = inv * (A[1] + mu_ * (M[1] - sumWY))
            Sxx = inv * inv * (Sq[0] - 2.0 * mu_ * A[0] - mu_ * mu_ * M[0]
                               + mu_ * mu_ * sumW)
            return Sx, Sxx, Sxy

        f = shard_map(
            local, mesh=self.mesh,
            in_specs=(P("snp", None), P("snp"), P("snp"),
                      P("task", None), P("task", None)),
            out_specs=(P("task", "snp"),) * 3, check_vma=False)
        return f(g.words, g.mu, g.inv_sd, W, WY)
