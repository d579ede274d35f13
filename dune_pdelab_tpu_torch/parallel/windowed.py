"""Window-sharded assembly: any mesh, any space, any rank partition.

PyTorch port of dune_pdelab_tpu/parallel/windowed.py on torch.distributed.
One abstraction, the per-rank DOF **window**, as in the reference:

  * elements (and faces, keyed by their inside element) are partitioned by
    an `element_owner` array: contiguous element-order slabs by default, or
    `block_partition(mesh, mesh_shape)` for a 2D/3D rank mesh on a
    structured grid;
  * each DOF is owned by the lowest rank whose elements touch it, and DOFs
    are renumbered so each rank's owned DOFs are one contiguous padded
    block of B rows (the ParallelHelper "winner takes the border DOF"
    ownership, reference: dune/pdelab/backend/istl/parallelhelper.hh:
    50-230). The renumbering, the (owner, index) lexsort of the reference,
    is kept exactly: padded vectors compare index for index with the
    reference's;
  * a rank's window is the sorted union of the (renumbered) DOFs of its
    entities, with the hanging-node parents of its rows. Window values
    arrive by one neighbour exchange (`Comm.sendrecv`: a buffer from each
    rank that owns some of the window, the genericdatahandle.hh:130
    `communicate()` analog);
  * the rank assembles into its window with the GridOperator's own kernels
    on its entities' slices of the contexts, and the window contributions
    go back to their owners by the reverse exchange and are summed, own
    rows first, then the peers in the reference's order (the border add
    exchange, novlpistlsolverbackend.hh:96, borderdofexchanger.hh:498);
  * hanging-node (affine) constraints apply window-locally: prolong after
    the exchange, restrict-transpose on the partial window residual before
    the combine (P^T sum_d r_d = sum_d P^T r_d).

The exchange, the combine and the flat conversions are differentiable
linear maps (torch.autograd.Function with a forward-mode rule and a
backward): torch.func.jvp and vjp see through the sharded residual, so the
one-step stage operators, Newton and the adjoint solves of
solvers/differentiable.py drive it unchanged. The exchange's transpose is
the combine and the other way round; the slice of a full (replicated)
vector and the all-gather of the blocks are each other's transposes.

Krylov solves (`solve_cg`, `solve_bicgstab`) run on the padded blocks with
the group's reproducible global dot (`Comm.dot`). Process model and capture rules:
parallel/__init__.py.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.func import jvp

from dune_pdelab_tpu_torch.assembly.dofmaps import IndexDofMap
from dune_pdelab_tpu_torch.ops.base import FaceContext, SkeletonContext, VolumeContext
from dune_pdelab_tpu_torch.parallel.comm import Comm, group_of, rank_device
from dune_pdelab_tpu_torch.utils.common import device_key


def block_partition(mesh, mesh_shape):
    """Element owner array for a structured mesh partitioned in blocks
    matching a rank grid `mesh_shape` (slowest mesh axes first). Rank id =
    C-order ravel of the block coordinates, so neighbouring blocks map to
    neighbouring ranks along each axis."""
    cells = tuple(mesh.cells)                # dim0 fastest
    dim = len(cells)
    nblk = tuple(mesh_shape)
    if len(nblk) > dim:
        raise ValueError("rank grid has more axes than the mesh")
    nblk = tuple(nblk) + (1,) * (dim - len(nblk))
    mi = mesh.element_multi_index()          # (E, dim) dim0 fastest
    owner = np.zeros(mesh.nelements, np.int64)
    for a, nb_a in enumerate(nblk):          # a-th slowest mesh axis
        d = dim - 1 - a
        c = cells[d]
        blk = np.minimum(mi[:, d] * nb_a // c, nb_a - 1)
        owner = owner * nb_a + blk
    return owner.astype(np.int32)


# -- the communicating linear maps, differentiable in both modes -------------
class _Exchange(torch.autograd.Function):
    """Owned block (B,) -> window values (W,)."""

    @staticmethod
    def forward(x, op):
        return op._exchange(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.op = inputs[1]

    @staticmethod
    def jvp(ctx, x_t, *_):
        return ctx.op._exchange(x_t)

    @staticmethod
    def backward(ctx, w_bar):
        return ctx.op._combine(w_bar), None


class _Combine(torch.autograd.Function):
    """Window contributions (W,) -> owned rows (B,), summed."""

    @staticmethod
    def forward(w, op):
        return op._combine(w)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.op = inputs[1]

    @staticmethod
    def jvp(ctx, w_t, *_):
        return ctx.op._combine(w_t)

    @staticmethod
    def backward(ctx, r_bar):
        return ctx.op._exchange(r_bar), None


class _Slice(torch.autograd.Function):
    """Full (N,) vector, the same on every rank -> this rank's block (B,)."""

    @staticmethod
    def forward(x, op):
        return op._slice(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.op = inputs[1]

    @staticmethod
    def jvp(ctx, x_t, *_):
        return ctx.op._slice(x_t)

    @staticmethod
    def backward(ctx, b_bar):
        return ctx.op._gather(b_bar), None


class _Gather(torch.autograd.Function):
    """This rank's block (B,) -> the full (N,) vector on every rank."""

    @staticmethod
    def forward(xb, op):
        return op._gather(xb)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.op = inputs[1]

    @staticmethod
    def jvp(ctx, x_t, *_):
        return ctx.op._gather(x_t)

    @staticmethod
    def backward(ctx, g_bar):
        return ctx.op._slice(g_bar), None


def _is_per_entity(name, t, n_ent, uniform):
    """Whether a context field carries the entity axis: the physical points
    always; weights and reference tabulations never; any other tensor on a
    non-uniform mesh (per-element or per-face geometry) when its leading
    dim is the entity count."""
    if name == "x":
        return True
    if name in ("weights", "phi", "ref_grad") or not isinstance(t, torch.Tensor):
        return False
    return (not uniform) and t.ndim > 0 and t.shape[0] == n_ent


def _slice_ctx(ctx, sel, n_ent, uniform):
    """The fields of a context for the entities `sel` (a tensor)."""
    out = {}
    for f in dataclasses.fields(ctx):
        v = getattr(ctx, f.name)
        if f.name == "time":
            continue
        if f.name in ("tabs", "tabs_in", "tabs_out"):
            v = tuple(dataclasses.replace(tab, **{
                k: getattr(tab, k)[sel] for k in ("grad", "vec_phi", "div", "curl")
                if _is_per_entity(k, getattr(tab, k), n_ent, uniform)}) for tab in v)
        elif _is_per_entity(f.name, v, n_ent, uniform):
            v = v[sel]
        out[f.name] = v
    return out


class WindowShardedGridOperator:
    """GridOperator with window-sharded vectors; works on any mesh/space.

    go: the sequential GridOperator (every rank builds the same one).
    devices / group: the process group (default: the world group).
    element_owner: (E,) rank of each element (default: contiguous slabs).
    device: this rank's device (default: parallel.comm.rank_device()).
    """

    def __init__(self, go, devices=None, axis_name="shard", element_owner=None,
                 group=None, device=None):
        if go.selective:
            raise ValueError("WindowShardedGridOperator takes no selective local "
                             "operator: its ranks run the kernels without the "
                             "element and face masks")
        self.go = go
        self.group = group_of(devices, group)
        self.comm = comm = Comm(self.group)
        self.device = rank_device(device)
        self.axis_name = axis_name
        ndev = comm.size
        me = comm.rank
        self.ndev = ndev
        self.cg = go.cg
        N = go.space.ndofs
        self.N = N
        E = go.mesh.nelements

        if element_owner is None:
            Eb = -(-E // ndev)
            element_owner = np.minimum(np.arange(E) // Eb, ndev - 1)
        eo = np.asarray(element_owner, np.int64)
        if eo.max() >= ndev:
            raise ValueError(f"element_owner names rank {eo.max()}, the group has {ndev}")
        self.element_owner = eo

        leaf_maps = [np.asarray(m, np.int64) for m in go._leaf_maps()]

        # ---- DOF ownership (lowest touching rank) + renumbering -----------
        dof_owner = np.full(N, ndev, np.int64)
        for m in leaf_maps:
            np.minimum.at(dof_owner, m.reshape(-1), np.repeat(eo, m.shape[1]))
        dof_owner[dof_owner == ndev] = 0
        counts = np.bincount(dof_owner, minlength=ndev)
        B = max(int(counts.max()), 1)
        self.B = B
        order = np.lexsort((np.arange(N), dof_owner))   # stable (owner, idx)
        pos_in_shard = np.empty(N, np.int64)
        start = 0
        for d in range(ndev):
            c = int(counts[d])
            pos_in_shard[order[start:start + c]] = np.arange(c)
            start += c
        pi = dof_owner * B + pos_in_shard
        self._pi = pi
        self.NP = ndev * B
        old_of_new = np.full(self.NP, -1, np.int64)
        old_of_new[pi] = np.arange(N)

        # ---- entity groups: owners + new-index dof maps --------------------
        # (kind, owner of each entity, new-index maps, face group or None)
        groups = [("vol", eo, [pi[m] for m in leaf_maps], None)]
        for g in go.bnd_groups:
            groups.append(("bnd", eo[go.group_elements(g)],
                           [pi[m] for m in go.group_leaf_dofs(g)], g))
        for g in go.skel_groups:
            groups.append(("skel", eo[go.group_elements(g)],
                           [pi[m] for m in go.group_leaf_dofs(g)]
                           + [pi[m] for m in go.group_leaf_dofs(g, True)], g))

        # ---- every rank's window (incl. affine parents) --------------------
        affine = go.cg is not None and go.cg.has_affine
        if affine:
            arows = pi[go.cg.affine_rows]
            acols = pi[go.cg.affine_cols]
            aw = go.cg.affine_weights
        wins = []
        for d in range(ndev):
            parts = [m[own == d].reshape(-1) for _, own, maps, _ in groups for m in maps]
            w = np.unique(np.concatenate(parts)) if parts else np.zeros(0, np.int64)
            if affine:
                # parents are never hanging (resolved transitively): one round
                w = np.union1d(w, acols[np.isin(arows, w)])
            wins.append(w if len(w) else np.array([d * B], np.int64))
        self._wins = wins
        win = wins[me]
        self.W = len(win)

        # ---- this rank's entities in window coordinates --------------------
        self._groups = []
        for kind, own, maps, g in groups:
            sel = np.nonzero(own == me)[0]
            if len(sel) == 0:
                continue
            self._groups.append({
                "kind": kind, "g": g, "sel": sel, "n": len(own),
                "maps": [IndexDofMap(np.searchsorted(win, m[sel])) for m in maps]})

        # ---- exchange plan -------------------------------------------------
        wo = win // B
        mine = np.nonzero(wo == me)[0]
        self._own_pos = mine
        self._own_idx = win[mine] - me * B
        self._recv = [(int(o), np.nonzero(wo == o)[0]) for o in np.unique(wo) if o != me]
        self._send = []
        for p in range(ndev):
            if p == me:
                continue
            wp = wins[p]
            rows = wp[wp // B == me] - me * B
            if len(rows):
                self._send.append((p, rows))
        # the combine adds the peers' contributions in the reference's order
        self._send.sort(key=lambda pr: pr[0] - me)

        # ---- window-local affine tables ------------------------------------
        self._aff = None
        if affine:
            sel = np.isin(arows, win)
            ar = np.searchsorted(win, arows[sel])
            ac = np.searchsorted(win, acols[sel])
            aww = aw[sel]
            hrows, inv, cnt = np.unique(ar, return_inverse=True, return_counts=True)
            K = int(cnt.max()) if len(cnt) else 1
            order_e = np.argsort(inv, kind="stable")
            slot = np.arange(len(ar)) - np.searchsorted(inv[order_e], inv[order_e])
            hcols = np.zeros((len(hrows), K), np.int64)
            hw = np.zeros((len(hrows), K))
            hcols[inv[order_e], slot] = ac[order_e]
            hw[inv[order_e], slot] = aww[order_e]
            hang = np.zeros(self.W, bool)
            old = old_of_new[win]
            hang[(old >= 0)] = go.cg.hanging_mask_np[old[old >= 0]]
            self._aff = {"rows": ar, "cols": ac, "w": aww, "hrows": hrows,
                         "hcols": hcols, "hw": hw, "hang": hang}

        # ---- masks ---------------------------------------------------------
        mask_np = np.ones(self.NP, bool)
        old_mask = (np.asarray(go.cg.mask_np, bool) if go.cg is not None
                    else np.zeros(N, bool))
        mask_np[pi] = old_mask
        self._mask_np = mask_np
        self.mask_padded = torch.as_tensor(mask_np[me * B:(me + 1) * B].copy(),
                                           device=self.device)
        self._my_old = old_of_new[me * B:(me + 1) * B]
        # the flat J.v: every rank's window in the full (old) numbering,
        # split into the slots its owner holds and the others
        self._win_old = np.maximum(old_of_new[win], 0)
        self._win_real = old_of_new[win] >= 0
        self._sum_plan = []
        for d in range(ndev):
            old_d, own_d = old_of_new[wins[d]], wins[d] // B == d
            real = old_d >= 0
            self._sum_plan.append((np.nonzero(own_d & real)[0], old_d[own_d & real],
                                   np.nonzero(~own_d & real)[0], old_d[~own_d & real]))
        self._wmax = max(len(w) for w in wins)
        self._cache = {}
        self._lin = None      # (x, x._version, time, its local J.v): jacobian_apply

    # ---- per (dtype, device) tensors ---------------------------------------
    def _t(self, key, build, device):
        k = key + (device_key(device),)
        if k not in self._cache:
            self._cache[k] = build()
        return self._cache[k]

    def _ints(self, name, a, device):
        return self._t(("i", name), lambda: torch.as_tensor(a, device=device), device)

    def _contexts(self, dtype, device):
        """Per group of this rank, its entities' slice of the GridOperator's
        context fields (without the time)."""
        def build():
            go = self.go
            uniform = bool(getattr(go.mesh, "uniform", False))
            out = []
            for grp in self._groups:
                sel = torch.as_tensor(grp["sel"], device=device)
                if grp["kind"] == "vol":
                    ctx = go._volume_ctx(0.0, dtype, device)
                elif grp["kind"] == "bnd":
                    ctx = go._face_ctx(grp["g"], 0.0, dtype, device)
                else:
                    ctx = go._skel_ctx(grp["g"], 0.0, dtype, device)
                out.append(_slice_ctx(ctx, sel, grp["n"], uniform))
            return out
        return self._t(("ctx", dtype), build, device)

    # ---- exchange / combine (the communicating linear maps) ----------------
    def _exchange(self, xloc):
        """Owned block (B,) -> window values (W,)."""
        dev = xloc.device
        w = torch.zeros(self.W, dtype=xloc.dtype, device=dev)
        w[self._ints("own_pos", self._own_pos, dev)] = xloc[
            self._ints("own_idx", self._own_idx, dev)]
        sends = [(p, xloc[self._ints(("send", p), rows, dev)]) for p, rows in self._send]
        recvs = [(o, torch.empty(len(pos), dtype=xloc.dtype, device=dev))
                 for o, pos in self._recv]
        self.comm.sendrecv(sends, recvs)
        for (o, pos), (_, buf) in zip(self._recv, recvs):
            w[self._ints(("recv", o), pos, dev)] = buf
        return w

    def _combine(self, rw):
        """Window contributions (W,) -> owned rows (B,), summed: own rows
        first, then each peer's in the order of the rank offset."""
        dev = rw.device
        r = torch.zeros(self.B, dtype=rw.dtype, device=dev)
        r[self._ints("own_idx", self._own_idx, dev)] = rw[
            self._ints("own_pos", self._own_pos, dev)]
        sends = [(o, rw[self._ints(("recv", o), pos, dev)]) for o, pos in self._recv]
        recvs = [(p, torch.empty(len(rows), dtype=rw.dtype, device=dev))
                 for p, rows in self._send]
        self.comm.sendrecv(sends, recvs)
        for (p, rows), (_, back) in zip(self._send, recvs):
            idx = self._ints(("send", p), rows, dev)
            r[idx] = r[idx] + back
        return r

    def _slice(self, x):
        """Full (N,) -> this rank's padded block (B,)."""
        x = x.to(self.device)
        valid = self._my_old >= 0
        xb = torch.zeros(self.B, dtype=x.dtype, device=x.device)
        xb[self._ints("valid", np.nonzero(valid)[0], x.device)] = x[
            self._ints("valid_old", self._my_old[valid], x.device)]
        return xb

    def _gather(self, xb):
        """Every rank's padded block -> the full (N,) vector on every rank."""
        full = torch.cat(self.comm.allgather(xb.contiguous()))
        return full[self._ints("pi", self._pi, xb.device)]

    # ---- window-local hanging-node maps ------------------------------------
    def _prolong_win(self, w):
        if self._aff is None:
            return w
        a, dev = self._aff, w.device
        vals = (torch.as_tensor(a["hw"], dtype=w.dtype, device=dev)
                * w[self._ints("hcols", a["hcols"], dev)]).sum(dim=1)
        out = w.clone()
        out[self._ints("hrows", a["hrows"], dev)] = vals
        return out

    def _restrict_t_win(self, rw):
        if self._aff is None:
            return rw
        a, dev = self._aff, rw.device

        def tmap():
            from dune_pdelab_tpu_torch.linalg.multigrid import transpose_map
            cols = torch.as_tensor(a["cols"], device=dev)
            tidx, tw = transpose_map(cols[:, None], torch.ones(
                (len(cols), 1), dtype=torch.float64, device=dev), self.W)
            return torch.where(tw != 0, tidx, len(cols))
        tidx = self._t(("aff_t",), tmap, dev)
        v = torch.as_tensor(a["w"], dtype=rw.dtype, device=dev) * rw[
            self._ints("arows", a["rows"], dev)]
        rw = rw + torch.cat([v, v.new_zeros(1)])[tidx].sum(dim=1)
        return torch.where(self._ints("hang", a["hang"], dev), 0.0, rw)

    # ---- the rank's window residual ----------------------------------------
    def _local(self, w, time, lambdas=True):
        """Window residual contributions of this rank's entities (W,)."""
        go = self.go
        lop = go.lop.set_time(time)
        has = go.has
        rw = torch.zeros_like(w)
        for grp, fields in zip(self._groups, self._contexts(w.dtype, w.device)):
            maps = grp["maps"]
            kind = grp["kind"]
            if kind == "vol":
                ctx = VolumeContext(time=time, **fields)
                if has["alpha_volume"]:
                    u = go._uarg([m.gather(w) for m in maps])
                    rw = go._scatter(rw, maps, go._pack(lop.alpha_volume(ctx, u)))
                if lambdas and has["lambda_volume"]:
                    rw = go._scatter(rw, maps, go._pack(lop.lambda_volume(ctx)))
            elif kind == "bnd":
                ctx = FaceContext(time=time, **fields)
                if has["alpha_boundary"]:
                    u = go._uarg([m.gather(w) for m in maps])
                    rw = go._scatter(rw, maps, go._pack(lop.alpha_boundary(ctx, u)))
                if lambdas and has["lambda_boundary"]:
                    rw = go._scatter(rw, maps, go._pack(lop.lambda_boundary(ctx)))
            else:
                ctx = SkeletonContext(time=time, **fields)
                n = len(maps) // 2
                r_in, r_out = lop.alpha_skeleton(
                    ctx, go._uarg([m.gather(w) for m in maps[:n]]),
                    go._uarg([m.gather(w) for m in maps[n:]]))
                rw = go._scatter(rw, maps[:n], go._pack(r_in))
                rw = go._scatter(rw, maps[n:], go._pack(r_out))
        return rw

    # ---- padded-block API -----------------------------------------------------
    def residual_unconstrained_padded(self, xp, time=0.0, lambdas=True):
        self.comm.refuse_capture("WindowShardedGridOperator")
        w = self._prolong_win(_Exchange.apply(xp, self))
        return _Combine.apply(self._restrict_t_win(self._local(w, time, lambdas)), self)

    def residual_padded(self, xp, time=0.0):
        r = self.residual_unconstrained_padded(xp, time)
        return torch.where(self.mask_padded, 0.0, r)

    def _linearization(self, xp):
        return self._prolong_win(self._exchange(xp))

    def _japply(self, wx, zp, time):
        """J z on padded blocks at the window state wx (exchanged and
        prolonged once per linearization point)."""
        self.comm.refuse_capture("WindowShardedGridOperator")
        mask = self.mask_padded
        wz = self._prolong_win(self._exchange(torch.where(mask, 0.0, zp)))
        _, jw = jvp(lambda w: self._local(w, time, lambdas=False), (wx,), (wz,))
        jz = self._combine(self._restrict_t_win(jw))
        return torch.where(mask, zp, jz)

    def jacobian_apply_padded(self, xp, zp, time=0.0):
        return self._japply(self._linearization(xp), zp, time)

    # ---- flat (N,) conversions ------------------------------------------------
    def device_put(self, x):
        """This rank's padded block of the full flat vector x."""
        return self._slice(torch.as_tensor(x))

    def gather(self, xp):
        """The full flat vector, on every rank."""
        return self._gather(xp)

    def residual(self, x, time=0.0):
        xp = _Slice.apply(torch.as_tensor(x), self)
        return _Gather.apply(self.residual_padded(xp, time), self)

    def residual_unconstrained(self, x, time=0.0, lambdas=True):
        """Flat unmasked residual (with the hanging-node P^T R(P x)): the
        duck type the one-step stage operators combine."""
        xp = _Slice.apply(torch.as_tensor(x), self)
        return _Gather.apply(self.residual_unconstrained_padded(xp, time, lambdas), self)

    def jacobian_apply(self, x, z, time=0.0):
        """Flat J(x) z on full vectors that every rank holds: each rank reads
        its window from x and z itself, and one all-gather of the window
        results replaces the halo exchange, the combine and the gather of
        the padded path; the sums keep the combine's order (the owner's
        contribution first, then the other ranks' in rank order), so the
        result is the padded path's, bit for bit. The window state of a
        tensor x is kept for the next call with the same, unchanged x (a
        Krylov loop's linearization point)."""
        self.comm.refuse_capture("WindowShardedGridOperator")
        x = torch.as_tensor(x).to(self.device)
        z = torch.as_tensor(z).to(self.device)
        held = self._lin
        if not (held is not None and held[0] is x and held[1] == x._version
                and held[2] == time):
            held = self._lin = (x, x._version, time, self._local_jv(x, time))
        return torch.where(self._full_mask(z.device), z, self._sum_windows(held[3](z)))

    def _local_jv(self, x, time):
        """z -> this rank's window contributions to J(x) z, which involve no
        communication: on the card replayed from a CUDA graph from its
        second call on (solvers/linear.py GraphedApply, the same bits)."""
        wx = self._prolong_win(self._window_of(x))
        mask = self._full_mask(x.device)

        def apply(z):
            wz = self._prolong_win(self._window_of(torch.where(mask, 0.0, z)))
            _, jw = jvp(lambda w: self._local(w, time, lambdas=False), (wx,), (wz,))
            return self._restrict_t_win(jw)
        if x.device.type == "cuda":
            from dune_pdelab_tpu_torch.solvers.linear import GraphedApply
            return GraphedApply(apply)
        return apply

    def _window_of(self, x):
        """This rank's window values (W,) read from a full (N,) vector."""
        dev = x.device
        w = x[self._ints("win_old", self._win_old, dev)]
        return torch.where(self._ints("win_real", self._win_real, dev), w, 0.0)

    def _full_mask(self, device):
        def build():
            m = (self.go.cg.mask_np if self.go.cg is not None
                 else np.zeros(self.N, bool))
            return torch.as_tensor(np.asarray(m, bool), device=device)
        return self._t(("full_mask",), build, device)

    def _sum_windows(self, rw):
        """Every rank's window contributions (W,) summed into the full (N,)
        vector on every rank, by one all-gather."""
        dev = rw.device
        pad = torch.zeros(self._wmax, dtype=rw.dtype, device=dev)
        pad[:len(rw)] = rw
        parts = self.comm.allgather(pad)
        y = torch.zeros(self.N, dtype=rw.dtype, device=dev)
        for d, part in enumerate(parts):
            own_pos, own_old = self._sum_plan[d][:2]
            y[self._ints(("own_old", d), own_old, dev)] = part[
                self._ints(("own_pos", d), own_pos, dev)]
        for d, part in enumerate(parts):
            pos, old = self._sum_plan[d][2:]
            idx = self._ints(("other_old", d), old, dev)
            y[idx] = y[idx] + part[self._ints(("other_pos", d), pos, dev)]
        return y

    def jacobian_diagonal(self, x, time=0.0):
        """Delegates to the sequential probe (a preconditioner-setup
        quantity, not the iteration hot path)."""
        return self.go.jacobian_diagonal(x, time)

    # ---- Krylov solves on the padded blocks ----------------------------------
    def _solve(self, run, x_lin, b, diag, tol, maxiter, time):
        xp = self._slice(torch.as_tensor(x_lin))
        bp = self._slice(torch.as_tensor(b))
        if diag is not None:
            dp = self._slice(torch.as_tensor(diag)).to(bp.dtype)
            dp = torch.where(dp == 0, 1.0, dp)

            def M(r):
                return r / dp
        else:
            def M(r):
                return r
        wx = self._linearization(xp)
        zp, stats = run(lambda z: self._japply(wx, z, time), bp, M=M, tol=tol,
                        maxiter=maxiter, dot=self.comm.dot)
        return self._gather(zp), stats

    def solve_cg(self, x_lin, b, diag=None, tol=1e-10, maxiter=5000, time=0.0):
        from dune_pdelab_tpu_torch.linalg.krylov import cg
        return self._solve(cg, x_lin, b, diag, tol, maxiter, time)

    def solve_bicgstab(self, x_lin, b, diag=None, tol=1e-10, maxiter=5000, time=0.0):
        from dune_pdelab_tpu_torch.linalg.krylov import bicgstab
        return self._solve(bicgstab, x_lin, b, diag, tol, maxiter, time)

    @property
    def space(self):
        return self.go.space

    @property
    def mesh(self):
        return self.go.mesh

    @property
    def lop(self):
        return self.go.lop
