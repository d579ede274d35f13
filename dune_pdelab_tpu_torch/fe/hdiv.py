"""H(div)-conforming vector finite elements: Raviart-Thomas and
Brezzi-Douglas-Marini on cubes and simplices.

PyTorch port of dune_pdelab_tpu/fe/hdiv.py (reference:
dune/pdelab/finiteelementmap/raviartthomasfem.hh, rt0cube2dfem.hh,
rt0cube3dfem.hh, rt0simplex2dfem.hh, rt1simplex2dfem.hh,
brezzidouglasmarinifem.hh:81, bdm1simplex2dfem.hh). Host numpy tabulation,
as in the reference: the port's own copy, with the same bases, DOF
functionals and local orderings. On cubes the DOFs are face moments of the
normal component with the GLOBAL face normal +e_axis, so shared faces need
no orientation flips; on simplices the space layer supplies per-element
diagonal signs (space/space.py `_build_hdiv_map_simplex`).

Vector elements provide `tabulate_vector` (values (npts, nb, dim)) and
`tabulate_div` ((npts, nb)) on the reference element; the assembler applies
the contravariant Piola map of the geometry.
"""
from __future__ import annotations

import numpy as np

from dune_pdelab_tpu_torch.fe.quadrature import gauss_legendre, simplex_rule


class VectorFiniteElement:
    geometry = "cube"
    continuity = "Hdiv"
    nodes = None

    def tabulate_vector(self, points):
        raise NotImplementedError

    def tabulate_div(self, points):
        raise NotImplementedError

    def tabulate(self, points):
        raise TypeError("vector element: use tabulate_vector/tabulate_div")

    def __repr__(self):
        return (f"{self.__class__.__name__}(dim={self.dim}, "
                f"nbasis={self.nbasis}, Hdiv)")


class RT0Cube(VectorFiniteElement):
    """Lowest-order Raviart-Thomas on the reference cube.

    Basis ordered (axis, side): [(a=0,s=0),(a=0,s=1),(a=1,s=0),...];
    phi_(a,0) = (1-x_a) * (-e_a ... sign choice: unit flux in +e_a on its
    face, zero on all others:
        phi_(a,s) . e_a = (1-x_a) if s==0 else x_a,   other components 0
    => div phi_(a,0) = -1, div phi_(a,1) = +1.
    """

    degree = 1

    def __init__(self, dim: int):
        self.dim = dim
        self.nbasis = 2 * dim
        # face of dof i: axis i//2, side i%2
        self.dof_axis = np.repeat(np.arange(dim), 2)
        self.dof_side = np.tile([0, 1], dim)

    def tabulate_vector(self, points):
        points = np.atleast_2d(points)
        npts = points.shape[0]
        v = np.zeros((npts, self.nbasis, self.dim))
        for a in range(self.dim):
            v[:, 2 * a, a] = 1.0 - points[:, a]
            v[:, 2 * a + 1, a] = points[:, a]
        return v

    def tabulate_div(self, points):
        points = np.atleast_2d(points)
        npts = points.shape[0]
        d = np.zeros((npts, self.nbasis))
        for a in range(self.dim):
            d[:, 2 * a] = -1.0
            d[:, 2 * a + 1] = 1.0
        return d


class BDM1Cube(VectorFiniteElement):
    """Brezzi-Douglas-Marini order 1 on the reference square (2D).

    8 DOFs: two moments (constant + linear) of the normal component per
    face, global +axis normals (reference: brezzidouglasmarinifem.hh:81).
    Basis built by moment-matching on the standard BDM1 space
    span{(1,0),(x,0),(y,0),(0,1),(0,x),(0,y),(x^2,-2xy),(-2xy? ...)} — for
    the cube: P1(dim)^2 + span{curl(x^2 y), curl(x y^2)}.
    """

    degree = 1

    def __init__(self, dim: int = 2):
        if dim != 2:
            raise NotImplementedError("BDM1Cube: 2D only")
        self.dim = 2
        self.nbasis = 8
        self.dof_axis = np.repeat(np.arange(2), 4)[:8:1][:8]
        # monomial basis for the BDM1 space on the square:
        # (1,0),(x,0),(y,0),(0,1),(0,x),(0,y), curl(x^2 y)=(x^2,-2xy),
        # curl(x y^2)=(2xy,-y^2)
        self._funcs = [
            lambda x, y: (np.ones_like(x), np.zeros_like(x)),
            lambda x, y: (x, np.zeros_like(x)),
            lambda x, y: (y, np.zeros_like(x)),
            lambda x, y: (np.zeros_like(x), np.ones_like(x)),
            lambda x, y: (np.zeros_like(x), x),
            lambda x, y: (np.zeros_like(x), y),
            lambda x, y: (x * x, -2 * x * y),
            lambda x, y: (2 * x * y, -y * y),
        ]
        self._divs = [
            lambda x, y: np.zeros_like(x),
            lambda x, y: np.ones_like(x),
            lambda x, y: np.zeros_like(x),
            lambda x, y: np.zeros_like(x),
            lambda x, y: np.zeros_like(x),
            lambda x, y: np.ones_like(x),
            lambda x, y: np.zeros_like(x),   # div curl = 0
            lambda x, y: np.zeros_like(x),
        ]
        self._C = np.linalg.inv(self._dof_matrix())

    # DOFs: per face (a, s): moments against 1 and (2t-1) of v.e_a, where t
    # is the tangential coordinate. Order: (a0,s0,m0),(a0,s0,m1),(a0,s1,m0),...
    def _dofs_of(self, fx, fdiv=None):
        xq, wq = gauss_legendre(5)
        out = []
        for a in range(2):
            t_axis = 1 - a
            for s in (0, 1):
                pts = np.zeros((len(xq), 2))
                pts[:, a] = float(s)
                pts[:, t_axis] = xq
                vx, vy = fx(pts[:, 0], pts[:, 1])
                vn = vx if a == 0 else vy
                out.append(np.dot(wq, vn))
                out.append(np.dot(wq * (2 * xq - 1), vn))
        return out

    def _dof_matrix(self):
        M = np.zeros((8, 8))
        for j, f in enumerate(self._funcs):
            M[:, j] = self._dofs_of(f)
        return M

    def tabulate_vector(self, points):
        points = np.atleast_2d(points)
        x, y = points[:, 0], points[:, 1]
        raw = np.zeros((len(points), 8, 2))
        for j, f in enumerate(self._funcs):
            vx, vy = f(x, y)
            raw[:, j, 0] = vx
            raw[:, j, 1] = vy
        return np.einsum("pjd,jb->pbd", raw, self._C)

    def tabulate_div(self, points):
        points = np.atleast_2d(points)
        x, y = points[:, 0], points[:, 1]
        raw = np.zeros((len(points), 8))
        for j, f in enumerate(self._divs):
            raw[:, j] = f(x, y)
        return raw @ self._C

    @property
    def ndofs_per_face(self):
        return 2


class RT0Simplex2D(VectorFiniteElement):
    """Lowest-order Raviart-Thomas on the reference triangle (reference:
    dune/pdelab/finiteelementmap/rt0simplex2dfem.hh).

    Reference triangle = the P1 geometry convention v0=(0,0), v1=(0,1),
    v2=(1,0). One dof per edge: the TOTAL outward normal flux. Local edge l
    is opposite vertex l (matching SimplexMesh.faces()); the basis is
    psi_l(x) = x - v_l, which has unit outward flux through edge l and zero
    through the others. Orientation to a global normal is a per-element
    diagonal sign, supplied by the space layer (space/space.py
    _build_hdiv_map simplex branch)."""

    geometry = "simplex"
    degree = 1
    ndofs_per_face = 1

    def __init__(self, dim: int = 2):
        if dim != 2:
            raise NotImplementedError("RT0Simplex: 2D only")
        self.dim = 2
        self.nbasis = 3
        self._verts = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0]])

    def tabulate_vector(self, points):
        points = np.atleast_2d(points)
        return points[:, None, :] - self._verts[None, :, :]

    def tabulate_div(self, points):
        points = np.atleast_2d(points)
        return np.full((len(points), 3), 2.0)


class RT0Simplex3D(VectorFiniteElement):
    """Lowest-order Raviart-Thomas on the reference tetrahedron (reference:
    dune/pdelab/finiteelementmap/rt0simplex2dfem.hh family, 3D member).

    Reference tet = the P1 geometry convention v0=(0,0,0), v1=(0,0,1),
    v2=(0,1,0), v3=(1,0,0). One dof per face (TOTAL outward flux); local
    face l is opposite vertex l. psi_l(x) = 2 (x - v_l) has unit outward
    flux through face l (h_l |f_l| = 3 |T| = 1/2) and is tangent to the
    other faces."""

    geometry = "simplex"
    degree = 1
    ndofs_per_face = 1

    def __init__(self, dim: int = 3):
        if dim != 3:
            raise NotImplementedError("RT0Simplex3D: 3D only")
        self.dim = 3
        self.nbasis = 4
        self._verts = np.array([[0.0, 0.0, 0.0], [0.0, 0.0, 1.0],
                                [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])

    def tabulate_vector(self, points):
        points = np.atleast_2d(points)
        return 2.0 * (points[:, None, :] - self._verts[None, :, :])

    def tabulate_div(self, points):
        points = np.atleast_2d(points)
        return np.full((len(points), 4), 6.0)


class BDM1Simplex2D(VectorFiniteElement):
    """Brezzi-Douglas-Marini order 1 on the reference triangle (reference:
    dune/pdelab/finiteelementmap/bdm1simplex2dfem.hh).

    Space = P1^2 (6 dofs): per edge, moments of the outward normal trace
    against {1, 2t-1}, t running from the lower- to the higher-LOCAL-index
    vertex of the edge. The odd moment flips sign under tangent reversal,
    so the space layer's global orientation uses the (sigma, sigma*tau)
    diagonal signs per edge."""

    geometry = "simplex"
    degree = 1
    ndofs_per_face = 2

    def __init__(self, dim: int = 2):
        if dim != 2:
            raise NotImplementedError("BDM1Simplex: 2D only")
        self.dim = 2
        self.nbasis = 6
        self._verts = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
        # P1^2 monomials: (1,0),(x,0),(y,0),(0,1),(0,x),(0,y)
        self._C = np.linalg.inv(self._dof_matrix())

    @staticmethod
    def _raw(points):
        x, y = points[:, 0], points[:, 1]
        n = len(points)
        vals = np.zeros((n, 6, 2))
        vals[:, 0, 0] = 1.0
        vals[:, 1, 0] = x
        vals[:, 2, 0] = y
        vals[:, 3, 1] = 1.0
        vals[:, 4, 1] = x
        vals[:, 5, 1] = y
        divs = np.zeros((n, 6))
        divs[:, 1] = 1.0
        divs[:, 5] = 1.0
        return vals, divs

    def _dof_matrix(self):
        xq, wq = gauss_legendre(5)
        # edge l opposite vertex l; endpoints by ascending local index
        edges = [(1, 2), (0, 2), (0, 1)]
        normals = np.array([[1.0, 1.0] / np.sqrt(2.0),
                            [0.0, -1.0], [-1.0, 0.0]])
        M = np.zeros((6, 6))
        for l, (a, b) in enumerate(edges):
            va, vb = self._verts[a], self._verts[b]
            elen = np.linalg.norm(vb - va)
            pts = va[None] + xq[:, None] * (vb - va)[None]
            raw, _ = self._raw(pts)
            vn = raw @ normals[l]                  # (nq, 6)
            M[2 * l] = (wq * elen) @ vn
            M[2 * l + 1] = (wq * elen * (2 * xq - 1)) @ vn
        return M

    def tabulate_vector(self, points):
        points = np.atleast_2d(points)
        raw, _ = self._raw(points)
        return np.einsum("pjd,jb->pbd", raw, self._C)

    def tabulate_div(self, points):
        points = np.atleast_2d(points)
        _, divs = self._raw(points)
        return divs @ self._C


class RT1Cube2D(VectorFiniteElement):
    """Raviart-Thomas order 1 on the reference square (reference:
    dune/pdelab/finiteelementmap/rt1cube2dfem.hh).

    Space Q_{2,1} x Q_{1,2} (12 dofs): per face two moments of the normal
    component against {1, 2t-1} (t the global tangential coordinate, so
    shared-face dofs agree between neighbors on structured meshes), plus
    four interior moments: v_x against {1, 2y-1}, v_y against {1, 2x-1}.
    Local ordering (a, s, m) faces then interior — matches the space
    layer's face-lattice numbering (space/space.py _build_hdiv_map)."""

    degree = 2
    ndofs_per_face = 2
    ndofs_interior = 4

    def __init__(self, dim: int = 2):
        if dim != 2:
            raise NotImplementedError("RT1Cube: 2D only")
        self.dim = 2
        self.nbasis = 12
        # Q_{2,1} for v_x: {1,x,x^2} x {1,y}; Q_{1,2} for v_y: {1,x} x {1,y,y^2}
        self._funcs = []
        self._divs = []
        for i in range(3):
            for j in range(2):
                self._funcs.append(("x", i, j))
                self._divs.append(("x", i, j))
        for i in range(2):
            for j in range(3):
                self._funcs.append(("y", i, j))
                self._divs.append(("y", i, j))
        self._C = np.linalg.inv(self._dof_matrix())

    def _eval_raw(self, points):
        x, y = points[:, 0], points[:, 1]
        n = len(points)
        vals = np.zeros((n, 12, 2))
        divs = np.zeros((n, 12))
        for jf, (comp, i, j) in enumerate(self._funcs):
            if comp == "x":
                vals[:, jf, 0] = x**i * y**j
                divs[:, jf] = (i * x**(i - 1) if i else 0.0) * y**j
            else:
                vals[:, jf, 1] = x**i * y**j
                divs[:, jf] = x**i * (j * y**(j - 1) if j else 0.0)
        return vals, divs

    def _dofs_of_raw(self):
        xq, wq = gauss_legendre(5)
        M = np.zeros((12, 12))
        row = 0
        for a in range(2):
            t_axis = 1 - a
            for s in (0, 1):
                pts = np.zeros((len(xq), 2))
                pts[:, a] = float(s)
                pts[:, t_axis] = xq
                raw, _ = self._eval_raw(pts)
                vn = raw[:, :, a]                      # (nq, 12)
                M[row] = wq @ vn
                M[row + 1] = (wq * (2 * xq - 1)) @ vn
                row += 2
        # interior: tensor GL grid
        X, Y = np.meshgrid(xq, xq, indexing="ij")
        W = np.outer(wq, wq).ravel()
        pts = np.stack([X.ravel(), Y.ravel()], axis=1)
        raw, _ = self._eval_raw(pts)
        M[8] = W @ raw[:, :, 0]
        M[9] = (W * (2 * pts[:, 1] - 1)) @ raw[:, :, 0]
        M[10] = W @ raw[:, :, 1]
        M[11] = (W * (2 * pts[:, 0] - 1)) @ raw[:, :, 1]
        return M

    def _dof_matrix(self):
        return self._dofs_of_raw()                     # M[dof, func]

    def tabulate_vector(self, points):
        points = np.atleast_2d(points)
        raw, _ = self._eval_raw(points)
        return np.einsum("pjd,jb->pbd", raw, self._C)

    def tabulate_div(self, points):
        points = np.atleast_2d(points)
        _, divs = self._eval_raw(points)
        return divs @ self._C


def _shifted_legendre(m, t):
    """Shifted Legendre P_m(2t-1) on [0,1] (orthogonal face moments)."""
    if m == 0:
        return np.ones_like(t)
    if m == 1:
        return 2.0 * t - 1.0
    pm2, pm1 = np.ones_like(t), 2.0 * t - 1.0
    for i in range(2, m + 1):
        pm2, pm1 = pm1, ((2 * i - 1) * (2.0 * t - 1.0) * pm1
                         - (i - 1) * pm2) / i
    return pm1


class RTkCube2D(VectorFiniteElement):
    """Raviart-Thomas order k on the reference square (reference:
    dune/pdelab/finiteelementmap/rt1cube2dfem.hh, rt2cube2dfem.hh,
    raviartthomasfem.hh).

    Space Q_{k+1,k} x Q_{k,k+1} (2(k+1)(k+2) dofs): per face k+1 moments of
    the normal component against shifted Legendre {P_0..P_k}(2t-1) (t the
    global tangential coordinate, shared-face dofs agree between structured
    neighbors), interior moments of v_x against Q_{k-1,k} and v_y against
    Q_{k,k-1}. Local ordering: faces (axis, side, moment), then interior."""

    def __init__(self, k: int, dim: int = 2):
        if dim != 2:
            raise NotImplementedError("RTkCube: 2D only")
        if k < 1:
            raise ValueError("use RT0Cube for the lowest order")
        self.dim = 2
        self.k = k
        self.degree = k + 1
        self.ndofs_per_face = k + 1
        self.ndofs_interior = 2 * k * (k + 1)
        self.nbasis = 2 * (k + 1) * (k + 2)
        # monomial basis: ('x', i<=k+1, j<=k), ('y', i<=k, j<=k+1)
        self._funcs = [("x", i, j) for i in range(k + 2) for j in range(k + 1)]
        self._funcs += [("y", i, j) for i in range(k + 1) for j in range(k + 2)]
        self._C = np.linalg.inv(self._dof_matrix())

    def _eval_raw(self, points):
        x, y = points[:, 0], points[:, 1]
        n = len(points)
        nb = self.nbasis
        vals = np.zeros((n, nb, 2))
        divs = np.zeros((n, nb))
        for jf, (comp, i, j) in enumerate(self._funcs):
            if comp == "x":
                vals[:, jf, 0] = x**i * y**j
                divs[:, jf] = (i * x**(i - 1) if i else 0.0) * y**j
            else:
                vals[:, jf, 1] = x**i * y**j
                divs[:, jf] = x**i * (j * y**(j - 1) if j else 0.0)
        return vals, divs

    def _dof_matrix(self):
        k = self.k
        xq, wq = gauss_legendre(k + 3)
        nb = self.nbasis
        M = np.zeros((nb, nb))
        row = 0
        for a in range(2):
            t_axis = 1 - a
            for s in (0, 1):
                pts = np.zeros((len(xq), 2))
                pts[:, a] = float(s)
                pts[:, t_axis] = xq
                raw, _ = self._eval_raw(pts)
                vn = raw[:, :, a]
                for m in range(k + 1):
                    M[row] = (wq * _shifted_legendre(m, xq)) @ vn
                    row += 1
        X, Y = np.meshgrid(xq, xq, indexing="ij")
        W = np.outer(wq, wq).ravel()
        pts = np.stack([X.ravel(), Y.ravel()], axis=1)
        raw, _ = self._eval_raw(pts)
        for i in range(k):          # v_x against Q_{k-1,k}
            for j in range(k + 1):
                M[row] = (W * pts[:, 0]**i * pts[:, 1]**j) @ raw[:, :, 0]
                row += 1
        for i in range(k + 1):      # v_y against Q_{k,k-1}
            for j in range(k):
                M[row] = (W * pts[:, 0]**i * pts[:, 1]**j) @ raw[:, :, 1]
                row += 1
        assert row == nb
        return M

    def tabulate_vector(self, points):
        points = np.atleast_2d(points)
        raw, _ = self._eval_raw(points)
        return np.einsum("pjd,jb->pbd", raw, self._C)

    def tabulate_div(self, points):
        points = np.atleast_2d(points)
        _, divs = self._eval_raw(points)
        return divs @ self._C


def RT2Cube2D():
    """RT2 on the square (rt2cube2dfem.hh analog)."""
    return RTkCube2D(2)


class RTkCube3D(VectorFiniteElement):
    """Raviart-Thomas order k on the reference hexahedron (reference:
    dune/pdelab/finiteelementmap/rt0cube3dfem.hh, raviartthomasfem.hh —
    the RT1Cube3D specialization is the reference's highest 3D cube order).

    Space Q_{k+1,k,k} x Q_{k,k+1,k} x Q_{k,k,k+1} (3(k+2)(k+1)^2 dofs):
    per face (k+1)^2 moments of the normal component against tensor shifted
    Legendre P_m(2t1-1) P_n(2t2-1) over the two tangential axes t1 < t2
    (moment index m*(k+1)+n — shared-face dofs agree between structured
    neighbors), plus 3k(k+1)^2 interior moments of v_a against
    Q_{..,k-1 along a,..}. Local ordering: faces (axis, side, moment), then
    interior (component, lexicographic exponents) — matching the space
    layer's face-lattice numbering (space/space.py _build_hdiv_map)."""

    def __init__(self, k: int = 1, dim: int = 3):
        if dim != 3:
            raise NotImplementedError("RTkCube3D: 3D only")
        if k < 1:
            raise ValueError("use RT0Cube for the lowest order")
        self.dim = 3
        self.k = k
        self.degree = k + 1
        self.ndofs_per_face = (k + 1) ** 2
        self.ndofs_interior = 3 * k * (k + 1) ** 2
        self.nbasis = 3 * (k + 2) * (k + 1) ** 2
        # monomial basis: component a with exponent <= k+1 along a, <= k else
        self._funcs = []
        for a in range(3):
            rng = [range(k + 2) if d == a else range(k + 1) for d in range(3)]
            for i in rng[0]:
                for j in rng[1]:
                    for l in rng[2]:
                        self._funcs.append((a, i, j, l))
        self._C = np.linalg.inv(self._dof_matrix())

    def _eval_raw(self, points):
        x = [points[:, d] for d in range(3)]
        n = len(points)
        nb = self.nbasis
        vals = np.zeros((n, nb, 3))
        divs = np.zeros((n, nb))
        for jf, (a, i, j, l) in enumerate(self._funcs):
            e = (i, j, l)
            mono = x[0] ** i * x[1] ** j * x[2] ** l
            vals[:, jf, a] = mono
            if e[a]:
                dm = e[a] * x[a] ** (e[a] - 1)
                for d in range(3):
                    if d != a:
                        dm = dm * x[d] ** e[d]
                divs[:, jf] = dm
        return vals, divs

    def _dof_matrix(self):
        k = self.k
        xq, wq = gauss_legendre(k + 3)
        nq = len(xq)
        nb = self.nbasis
        M = np.zeros((nb, nb))
        row = 0
        X1, X2 = np.meshgrid(xq, xq, indexing="ij")
        Wf = np.outer(wq, wq).ravel()
        for a in range(3):
            t1, t2 = [d for d in range(3) if d != a]
            for s in (0, 1):
                pts = np.zeros((nq * nq, 3))
                pts[:, a] = float(s)
                pts[:, t1] = X1.ravel()
                pts[:, t2] = X2.ravel()
                raw, _ = self._eval_raw(pts)
                vn = raw[:, :, a]
                for m in range(k + 1):
                    pm = _shifted_legendre(m, pts[:, t1])
                    for nmo in range(k + 1):
                        pn = _shifted_legendre(nmo, pts[:, t2])
                        M[row] = (Wf * pm * pn) @ vn
                        row += 1
        # interior: tensor GL grid
        XX, YY, ZZ = np.meshgrid(xq, xq, xq, indexing="ij")
        W = np.einsum("i,j,l->ijl", wq, wq, wq).ravel()
        pts = np.stack([XX.ravel(), YY.ravel(), ZZ.ravel()], axis=1)
        raw, _ = self._eval_raw(pts)
        for a in range(3):
            rng = [range(k) if d == a else range(k + 1) for d in range(3)]
            for i in rng[0]:
                for j in rng[1]:
                    for l in rng[2]:
                        w = (W * pts[:, 0] ** i * pts[:, 1] ** j
                             * pts[:, 2] ** l)
                        M[row] = w @ raw[:, :, a]
                        row += 1
        assert row == nb
        return M

    def tabulate_vector(self, points):
        points = np.atleast_2d(points)
        raw, _ = self._eval_raw(points)
        return np.einsum("pjd,jb->pbd", raw, self._C)

    def tabulate_div(self, points):
        points = np.atleast_2d(points)
        _, divs = self._eval_raw(points)
        return divs @ self._C


def RT1Cube3D():
    """RT1 on the hexahedron (raviartthomasfem.hh RT1Cube3D analog)."""
    return RTkCube3D(1)


class RT1Simplex2D(VectorFiniteElement):
    """Raviart-Thomas order 1 on the reference triangle (reference:
    dune/pdelab/finiteelementmap/rt1simplex2dfem.hh).

    Space (P1)^2 + x * P1_homog (8 dofs): per edge moments of the outward
    normal trace against {1, 2t-1} (t ascending local vertex index — the
    sigma/sigma*tau orientation convention of BDM1Simplex2D), plus interior
    moments of v against {e_x, e_y}. Interior dofs are element-private and
    carry no orientation sign."""

    geometry = "simplex"
    degree = 2
    ndofs_per_face = 2
    ndofs_interior = 2

    def __init__(self, dim: int = 2):
        if dim != 2:
            raise NotImplementedError("RT1Simplex: 2D only")
        self.dim = 2
        self.nbasis = 8
        self._verts = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
        self._C = np.linalg.inv(self._dof_matrix())

    @staticmethod
    def _raw(points):
        x, y = points[:, 0], points[:, 1]
        n = len(points)
        vals = np.zeros((n, 8, 2))
        # (P1)^2: (1,0),(x,0),(y,0),(0,1),(0,x),(0,y); + (x^2,xy),(xy,y^2)
        vals[:, 0, 0] = 1.0
        vals[:, 1, 0] = x
        vals[:, 2, 0] = y
        vals[:, 3, 1] = 1.0
        vals[:, 4, 1] = x
        vals[:, 5, 1] = y
        vals[:, 6, 0] = x * x
        vals[:, 6, 1] = x * y
        vals[:, 7, 0] = x * y
        vals[:, 7, 1] = y * y
        divs = np.zeros((n, 8))
        divs[:, 1] = 1.0
        divs[:, 5] = 1.0
        divs[:, 6] = 3.0 * x
        divs[:, 7] = 3.0 * y
        return vals, divs

    def _dof_matrix(self):
        xq, wq = gauss_legendre(5)
        edges = [(1, 2), (0, 2), (0, 1)]         # edge l opposite vertex l
        normals = np.array([[1.0, 1.0] / np.sqrt(2.0),
                            [0.0, -1.0], [-1.0, 0.0]])
        M = np.zeros((8, 8))
        for l, (a, b) in enumerate(edges):
            va, vb = self._verts[a], self._verts[b]
            elen = np.linalg.norm(vb - va)
            pts = va[None] + xq[:, None] * (vb - va)[None]
            raw, _ = self._raw(pts)
            vn = raw @ normals[l]
            M[2 * l] = (wq * elen) @ vn
            M[2 * l + 1] = (wq * elen * (2 * xq - 1)) @ vn
        # interior: integrals of v over the triangle (collapsed GL grid)
        pts, w = simplex_rule(2, 4)
        raw, _ = self._raw(np.atleast_2d(pts))
        M[6] = w @ raw[:, :, 0]
        M[7] = w @ raw[:, :, 1]
        return M

    def tabulate_vector(self, points):
        points = np.atleast_2d(points)
        raw, _ = self._raw(points)
        return np.einsum("pjd,jb->pbd", raw, self._C)

    def tabulate_div(self, points):
        points = np.atleast_2d(points)
        _, divs = self._raw(points)
        return divs @ self._C
