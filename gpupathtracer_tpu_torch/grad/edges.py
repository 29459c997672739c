"""Silhouette (visibility) gradients by edge sampling: the boundary term.

Counterpart of ``gpupathtracer_tpu/grad/edges.py``. The detached estimator
of ``render_frame`` treats visibility as constant, so its geometry and
camera gradients miss the motion of silhouettes. This module estimates
that boundary integral by sampling points on silhouette edges (Li et al.
2018, "Differentiable Monte Carlo Ray Tracing through Edge Sampling", for
the renderer's box pixel filter):

    dI_p/dθ  +=  ∫_{silhouette edges}  (f_in − f_out)(x) · (n̂ · dx_s/dθ) dl_s

with x_s the edge point in screen (pixel) coordinates, n̂ the screen
normal of the edge pointing away from the occluder and f_in / f_out the
radiance just inside and outside the silhouette.

1. A host-side edge table (unique edges and their faces, by hashing
   quantized endpoints; ``build_edge_table``), and for large meshes a
   two-level cluster hierarchy over it (``build_edge_clusters``).
2. Silhouette classification against the camera, or against a shading
   point for shadows: data, not shape.
3. Edge points drawn ∝ screen chord length (categorical over edges,
   uniform along the edge, the exact |dx_s/ds| Jacobian by forward-mode
   AD), with ``jax.random``'s threefry draws (``ops/threefry.py``), so the
   samples are the JAX package's.
4. f_in / f_out traced through screen points nudged ±ε pixels across the
   edge with the regular path tracer (``_trace_at_screen``), or, for
   shadows, one-bounce rays from the shading point grazing either side of
   the edge (``f_sa``); the searches are the renderer's (the packed
   kernels on the card).
5. θ enters only through the projected edge point: one
   ``torch.autograd.grad`` of Σ w·(n̂·x_s(θ)) with detached weights w
   gives dL/dθ for any parameter feeding ``scene_fn`` (and ``camera_fn``).

``primary_edge_gradient`` is the camera-silhouette term,
``shadow_edge_gradient`` the NEE shadow-silhouette term at the first (and
optionally the second) diffuse vertex, through mirror and glass prefixes;
``value_and_grad_with_edges`` adds them to the interior term of
``render_frame`` (its parts run in the profiler spans ``edges.interior``,
``edges.primary`` and ``edges.shadow``, the hierarchical picker in
``edges.pick_hierarchical``). ``params`` is a tensor or a dict of tensors;
gradients come back in the same structure. Every function runs on ``device``, the
card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gpupathtracer_tpu_torch.core.tensors import clip, maximum, resolve_device
from gpupathtracer_tpu_torch.models.camera import (
    Camera,
    generate_rays_for_pixels,
    projection_matrix,
    view_matrix,
)
from gpupathtracer_tpu_torch.models.materials import BxdfType, textured_albedo
from gpupathtracer_tpu_torch.models.scene import TriangleScene
from gpupathtracer_tpu_torch.ops import threefry
from gpupathtracer_tpu_torch.ops.intersect import resolve_hits
from gpupathtracer_tpu_torch.ops.sampling import (
    cosine_sample_hemisphere,
    fresnel_schlick,
    local_to_world,
    make_sampler,
    normalize_dir,
    reflect,
    refract,
)
from gpupathtracer_tpu_torch.render.integrator import RAY_OFFSET, make_intersect_fn, trace_paths
from gpupathtracer_tpu_torch.render.renderer import (
    RenderSettings,
    _integrator_options,
    narrow_settings,
    render_frame,
)
from gpupathtracer_tpu_torch.utils.profiling import scope

# Above this edge count, shadow_edge_gradient switches to the two-level
# cluster hierarchy (EdgeClusters) automatically.
_HIER_EDGE_THRESHOLD = 8192
# The primary term's (n_samples, E) Gumbel draw is made in row chunks of at
# most this many elements (the same picks: threefry bits depend only on
# the element's flat index).
_GUMBEL_CHUNK_ELEMENTS = 1 << 24


@dataclasses.dataclass(frozen=True)
class EdgeTable:
    """Unique mesh edges with face adjacency (host-built, topology-static).

    Edge e is corner ``corner[e]`` of triangle ``tri1[e]``, endpoints
    (P_corner, P_corner+1 mod 3) of that triangle, shared with ``tri2[e]``
    (-1 for boundary edges). ``two_sided`` marks edges whose owner triangle
    is two-sided (silhouette rules differ, see silhouette_flags).
    """

    tri1: np.ndarray  # (E,) int32
    corner: np.ndarray  # (E,) int32 in {0,1,2}
    tri2: np.ndarray  # (E,) int32, -1 = boundary
    two_sided: np.ndarray  # (E,) bool

    @property
    def num_edges(self) -> int:
        return self.tri1.shape[0]


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def build_edge_table(scene: TriangleScene, native: bool = True) -> EdgeTable:
    """Hash quantized endpoint pairs → unique edges and adjacency.

    Works on triangle soups (the scene format): duplicated vertices merge by
    position quantization (1e-5 of the bbox diagonal). Non-manifold extras
    (more than 2 faces on an edge) keep the first two faces. ``native=True``
    runs the C++ builder (``native.build_edge_table_native``), and raises
    with the compiler's message when it cannot be built; ``native=False``
    runs the Python loop of the JAX package, with its dict insertion order.
    Both give the JAX package's arrays.
    """
    if native:
        from gpupathtracer_tpu_torch import native as native_mod

        return native_mod.build_edge_table_native(scene)
    v0, e1, e2 = _host(scene.v0), _host(scene.e1), _host(scene.e2)
    valid = _host(scene.valid)
    two = _host(scene.two_sided)
    corners = np.stack([v0, v0 + e1, v0 + e2], axis=1)  # (T, 3, 3)

    live = np.where(valid)[0]
    pts = corners[live].reshape(-1, 3)
    diag = float(np.linalg.norm(pts.max(0) - pts.min(0))) if pts.size else 1.0
    q = 1e-5 * max(diag, 1e-12)
    qc = np.round(corners / q).astype(np.int64)  # (T, 3, 3) quantized

    edges: dict[tuple, list] = {}
    for t in live:
        for k in range(3):
            a = tuple(qc[t, k])
            b = tuple(qc[t, (k + 1) % 3])
            key = (a, b) if a <= b else (b, a)
            rec = edges.get(key)
            if rec is None:
                edges[key] = [t, k, -1]
            elif rec[2] == -1 and rec[0] != t:
                rec[2] = t
    tri1 = np.asarray([r[0] for r in edges.values()], np.int32)
    corner = np.asarray([r[1] for r in edges.values()], np.int32)
    tri2 = np.asarray([r[2] for r in edges.values()], np.int32)
    return EdgeTable(tri1=tri1, corner=corner, tri2=tri2, two_sided=two[tri1])


@dataclasses.dataclass(frozen=True)
class EdgeClusters:
    """Two-level edge hierarchy for per-shading-point silhouette sampling.

    Edges are Morton-sorted by midpoint and grouped into fixed-size
    clusters; each cluster carries conservative bounds that decide "can
    this cluster hold a silhouette edge with respect to point x" in O(1):

    - componentwise bounds of the adjacent-face normals (``gn_lo``/``gn_hi``)
      and of their plane constants ``dot(gn, v0)`` (``c_lo``/``c_hi``): the
      sign interval of ``dot(gn_i, x) − c_i`` over the cluster's faces
      decides all-front / all-back / mixed; only mixed clusters (or ones
      holding boundary or two-sided boundary edges) can silhouette;
    - an endpoint AABB (``box_lo``/``box_hi``) whose angular size from x
      proxies the cluster's total direction chord for importance weighting.

    Per point, one cluster is sampled ∝ its conservative weight, then exact
    silhouette chords are computed for that cluster's edges only. Every edge
    with a nonzero chord keeps a nonzero pick probability, so the estimator
    stays unbiased; the hierarchy changes the variance only.
    """

    size: int  # edges per cluster (last cluster padded with -1)
    edge_ids: np.ndarray  # (C, size) int32, -1 padding
    gn_lo: np.ndarray  # (C, 3)
    gn_hi: np.ndarray  # (C, 3)
    c_lo: np.ndarray  # (C,)
    c_hi: np.ndarray  # (C,)
    box_lo: np.ndarray  # (C, 3) endpoint AABB
    box_hi: np.ndarray  # (C, 3)
    count: np.ndarray  # (C,) real edges
    has_boundary: np.ndarray  # (C,) bool, one-sided boundary edges present
    has_two_boundary: np.ndarray  # (C,) bool, two-sided boundary edges present

    @property
    def num_clusters(self) -> int:
        return self.edge_ids.shape[0]


def build_edge_clusters(scene: TriangleScene, table: EdgeTable, cluster_size: int = 256) -> EdgeClusters:
    """Host-side cluster build (topology-static, like the edge table),
    vectorised numpy, the JAX package's arithmetic."""
    v0, e1, e2, gn = _host(scene.v0), _host(scene.e1), _host(scene.e2), _host(scene.gn)
    tri1, corner, tri2 = table.tri1, table.corner, table.tri2
    pts = np.stack([v0, v0 + e1, v0 + e2], axis=1)  # (T,3,3)
    va = pts[tri1, corner]
    vb = pts[tri1, (corner + 1) % 3]
    mid = 0.5 * (va + vb)

    lo, hi = mid.min(0), mid.max(0)
    span = np.maximum(hi - lo, 1e-12)
    q = np.clip((mid - lo) / span * 1023.0, 0, 1023).astype(np.uint32)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    codes = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    order = np.argsort(codes, kind="stable").astype(np.int32)

    e = table.num_edges
    c = -(-e // cluster_size)
    ids = np.full((c, cluster_size), -1, np.int32)
    ids.ravel()[:e] = order
    two = table.two_sided

    valid = ids >= 0
    sel0 = np.maximum(ids, 0)
    t1 = tri1[sel0]  # (C, size)
    t2 = tri2[sel0]
    has2 = valid & (t2 >= 0)
    n1 = gn[t1]  # (C, size, 3)
    n2 = gn[np.maximum(t2, 0)]
    c1 = np.einsum("csk,csk->cs", n1, v0[t1])
    c2 = np.einsum("csk,csk->cs", n2, v0[np.maximum(t2, 0)])

    def mmin(x, mask, init):
        return np.where(mask[..., None] if x.ndim == 3 else mask, x, init)

    big = np.float32(np.inf)
    n_stack_lo = np.minimum(mmin(n1, valid, big), mmin(n2, has2, big)).min(axis=1)
    n_stack_hi = np.maximum(mmin(n1, valid, -big), mmin(n2, has2, -big)).max(axis=1)
    c_lo = np.minimum(mmin(c1, valid, big), mmin(c2, has2, big)).min(axis=1)
    c_hi = np.maximum(mmin(c1, valid, -big), mmin(c2, has2, -big)).max(axis=1)
    ep = np.concatenate([va[sel0], vb[sel0]], axis=1)  # (C, 2*size, 3)
    vmask = np.concatenate([valid, valid], axis=1)
    box_lo = np.where(vmask[..., None], ep, big).min(axis=1)
    box_hi = np.where(vmask[..., None], ep, -big).max(axis=1)
    count = valid.sum(axis=1).astype(np.int32)
    bnd = valid & (t2 < 0)
    has_b = (bnd & ~two[sel0]).any(axis=1)
    has_tb = (bnd & two[sel0]).any(axis=1)
    return EdgeClusters(
        size=cluster_size, edge_ids=ids, gn_lo=n_stack_lo.astype(np.float32), gn_hi=n_stack_hi.astype(np.float32),
        c_lo=c_lo.astype(np.float32), c_hi=c_hi.astype(np.float32), box_lo=box_lo.astype(np.float32),
        box_hi=box_hi.astype(np.float32), count=count, has_boundary=has_b, has_two_boundary=has_tb,
    )


def _on(a: np.ndarray, device) -> torch.Tensor:
    """A host table array as a tensor on ``device``, int32 indices as int64."""
    t = torch.as_tensor(a, device=device)
    return t.long() if t.dtype == torch.int32 else t


def _safe_logits(w: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """log(w) where w > 0, else -inf; rows whose total is 0 become all
    zeros, so their (masked) draw stays finite."""
    logits = torch.where(w > 0, torch.log(maximum(w, 1e-30)), -math.inf)
    return torch.where(total > 0, logits, torch.zeros_like(logits))


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / maximum(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-12)


def _pick_edges_hierarchical(scene, table, clusters: EdgeClusters, x, va, vb, key):
    """Sample one candidate silhouette edge per shading point through the
    cluster hierarchy. Returns ``(pick, q)``: edge ids (clamped ≥ 0) and
    the total pick probability (0 ⇒ wasted sample, masked by the caller).
    """
    dev = x.device
    k_c, k_e = threefry.split(key)
    gl, gh = _on(clusters.gn_lo, dev), _on(clusters.gn_hi, dev)
    # Sign interval of dot(gn_i, x) − c_i over the cluster's faces.
    a, b = gl[None] * x[:, None], gh[None] * x[:, None]
    prod_lo = torch.minimum(a, b).sum(-1)
    prod_hi = torch.maximum(a, b).sum(-1)
    lower = prod_lo - _on(clusters.c_hi, dev)[None]
    upper = prod_hi - _on(clusters.c_lo, dev)[None]
    # lower <= 0 (not < 0): the flat classifier calls dot(gn,x)-c == 0
    # back-facing (front ⇔ dot > 0), so an edge whose back face evaluates
    # exactly 0 is a silhouette and must keep nonzero pick probability; the
    # conservative interval must include that boundary.
    mixed = (lower <= 0) & (upper > 0)
    possible = mixed | (_on(clusters.has_boundary, dev)[None] & (upper > 0)) | _on(clusters.has_two_boundary, dev)[None]
    center = _on(0.5 * (clusters.box_lo + clusters.box_hi), dev)
    radius = _on(0.5 * np.linalg.norm(clusters.box_hi - clusters.box_lo, axis=-1), dev)
    dist = torch.linalg.norm(x[:, None] - center[None], dim=-1)
    ang = clip(radius[None] / torch.maximum(dist, radius[None] + 1e-12), 1e-3, 1.0)
    w_c = possible * ang * _on(clusters.count, dev).float()[None]  # (M, C)
    tot_c = w_c.sum(-1)
    ci = threefry.categorical(k_c, _safe_logits(w_c, tot_c[:, None]))  # (M,)
    q_c = w_c.gather(-1, ci[:, None])[:, 0] / maximum(tot_c, 1e-30)

    # Exact silhouette chords for the chosen cluster's edges only.
    eid = _on(clusters.edge_ids, dev)[ci]  # (M, size)
    valid_e = eid >= 0
    e0 = eid.clamp(min=0)
    tri1 = _on(table.tri1, dev)[e0]
    tri2 = _on(table.tri2, dev)[e0]
    two = _on(table.two_sided, dev)[e0]
    f1 = torch.einsum("msk,msk->ms", scene.gn[tri1], x[:, None] - scene.v0[tri1]) > 0
    boundary = tri2 < 0
    t2c = tri2.clamp(min=0)
    f2 = torch.where(boundary, f1, torch.einsum("msk,msk->ms", scene.gn[t2c], x[:, None] - scene.v0[t2c]) > 0)
    sil = torch.where(boundary, f1 | two, f1 != f2) & valid_e
    chord = torch.linalg.norm(_unit(va[e0] - x[:, None]) - _unit(vb[e0] - x[:, None]), dim=-1) * sil  # (M, size)
    tot_e = chord.sum(-1)
    pe = threefry.categorical(k_e, _safe_logits(chord, tot_e[:, None]))  # (M,)
    q_e = chord.gather(-1, pe[:, None])[:, 0] / maximum(tot_e, 1e-30)
    pick = e0.gather(-1, pe[:, None])[:, 0]
    q = torch.where((tot_c > 0) & (tot_e > 0), q_c * q_e, 0.0)
    return pick, q


def edge_endpoints(scene: TriangleScene, tri1: torch.Tensor, corner: torch.Tensor):
    """Differentiable endpoint gather: (va, vb) each (E, 3)."""
    v0 = scene.v0[tri1]
    p = torch.stack([v0, v0 + scene.e1[tri1], v0 + scene.e2[tri1]], dim=1)  # (E,3,3)
    e = torch.arange(tri1.shape[0], device=tri1.device)
    return p[e, corner], p[e, (corner + 1) % 3]


def silhouette_flags(scene: TriangleScene, table: EdgeTable, viewpoint: torch.Tensor):
    """(is_sil, interior_tri): silhouette classification wrt a viewpoint.

    One-sided faces: boundary edge of a front face, or shared edge with
    front(f1) ⊕ front(f2). Two-sided faces: boundary edges always (both
    sides render); shared two-sided edges are creases (radiance continuous
    to first order) and skipped, as are interior shading creases, which are
    not visibility events. ``interior_tri`` is the front-facing owner, whose
    screen interior defines the occluder side of the edge.
    """
    dev = scene.v0.device
    tri1, tri2 = _on(table.tri1, dev), _on(table.tri2, dev)

    def front(t):  # dot(gn, viewpoint - point_on_tri) > 0: one-sided visibility
        return (scene.gn[t] * (viewpoint[None, :] - scene.v0[t])).sum(-1) > 0

    f1 = front(tri1)
    boundary = tri2 < 0
    f2 = torch.where(boundary, f1, front(tri2.clamp(min=0)))
    is_sil = torch.where(boundary, f1 | _on(table.two_sided, dev), f1 != f2)
    interior = torch.where(f1, tri1, torch.where(boundary, tri1, tri2.clamp(min=0)))
    return is_sil, interior


def _clip_coords(cam: Camera, p: torch.Tensor) -> torch.Tensor:
    m = projection_matrix(cam) @ view_matrix(cam)
    return torch.cat([p, torch.ones_like(p[:, :1])], dim=-1) @ m.T


def screen_xy(cam: Camera, p: torch.Tensor) -> torch.Tensor:
    """World points (M,3) → float pixel coordinates (M,2).

    The inverse of the ray generation: the ray for screen coordinate (x, y)
    passes through NDC ((x/W)·2−1, 1−(y/H)·2), so the forward projection is
    proj·view and the divide, then x = (ndc_x+1)/2·W, y = (1−ndc_y)/2·H; the
    pixel is the floor.
    """
    clip_c = _clip_coords(cam, p)
    w = torch.where(clip_c[:, 3:4].abs() < 1e-12, 1e-12, clip_c[:, 3:4])
    ndc = clip_c[:, :2] / w
    x = (ndc[:, 0] + 1.0) * 0.5 * cam.width
    y = (1.0 - ndc[:, 1]) * 0.5 * cam.height
    return torch.stack([x, y], dim=-1)


def _clip_w(cam: Camera, p: torch.Tensor) -> torch.Tensor:
    return _clip_coords(cam, p)[:, 3]


def _trace_at_screen(scene, cam: Camera, settings: RenderSettings, xy, key_data, spp: int):
    """Mean radiance (M,3) of rays through float screen coords (M,2);
    ``key_data`` are the two words of a threefry key, which the sampler
    takes as its base key."""
    m = xy.shape[0]
    opts = _integrator_options(settings)
    # generate_rays_for_pixels(idx=0, jitter=(x, y)) places the ray exactly
    # at screen coordinate (x, y): the jitter convention is additive pixels.
    o, d = generate_rays_for_pixels(cam, torch.zeros(m, dtype=torch.int64, device=xy.device), xy)
    sampler = make_sampler(opts.rng)
    lane_ids = torch.arange(m, device=xy.device)
    acc = torch.zeros((m, 3), dtype=torch.float32, device=xy.device)
    for s in range(spp):
        acc = acc + trace_paths(scene, o, d, sampler.path_keys(key_data, lane_ids, s), opts)
    return acc / spp


def _detached(cam: Camera) -> Camera:
    return dataclasses.replace(
        cam, **{f.name: v.detach() for f in dataclasses.fields(cam) if isinstance(v := getattr(cam, f.name), torch.Tensor)}
    )


def _leaves(params):
    """Fresh leaves of ``params`` (a tensor or a dict of tensors) that
    require a gradient, and their flat list."""
    if isinstance(params, torch.Tensor):
        leaf = params.detach().requires_grad_()
        return leaf, [leaf]
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    return leaves, list(leaves.values())


def _grads_like(params, flat, grads):
    """``grads`` of the flat leaves in ``params``' structure, zeros where
    no gradient reached (as ``jax.grad`` gives them)."""
    g = [torch.zeros_like(x) if gi is None else gi for x, gi in zip(flat, grads)]
    if isinstance(params, torch.Tensor):
        return g[0]
    return dict(zip(params.keys(), g))


def _grad_of(scalar_fn, params):
    """d scalar_fn(params) / d params, in ``params``' structure."""
    leaves, flat = _leaves(params)
    with torch.enable_grad():
        val = scalar_fn(leaves)
        grads = torch.autograd.grad(val, flat, allow_unused=True) if val.requires_grad else [None] * len(flat)
    return _grads_like(params, flat, grads)


def _zero_grads(params):
    if isinstance(params, torch.Tensor):
        return torch.zeros_like(params)
    return {k: torch.zeros_like(v) for k, v in params.items()}


def _detached_inputs(scene_fn, params, camera, camera_fn, device):
    """The scene and camera at ``params``, detached, on ``device``."""
    with torch.no_grad():
        scene = scene_fn(params).to(device)
        cam = camera_fn(params) if camera_fn is not None else camera
    return scene, _detached(cam.to(device))


def primary_edge_gradient(
    scene_fn,
    params,
    camera: Camera,
    settings: RenderSettings,
    cot_image: torch.Tensor,  # (H, W, 3) dL/dI, the loss cotangent
    table: EdgeTable,
    key: torch.Tensor,
    n_samples: int = 1024,
    trace_spp: int = 4,
    eps_px: float = 0.05,
    camera_fn=None,
    device="cuda",
):
    """Boundary-term gradient dL/d(params) from primary silhouettes.

    ``scene_fn(params) -> TriangleScene`` is differentiable; the edge table
    is topology-static (rebuild only when connectivity changes). Everything
    but the final gradient is detached: sampling, classification, radiance
    differences and pdfs are data. ``camera_fn(params) -> Camera``
    (optional) makes the camera a differentiation target: the samples are
    drawn with the detached camera and only ``boundary_scalar`` projects
    through ``camera_fn(params)``. ``key`` is a threefry key
    (``ops/threefry.PRNGKey``).
    """
    device = resolve_device(device)
    key = key.to(device)
    scene, cam_d = _detached_inputs(scene_fn, params, camera, camera_fn, device)
    # The same narrowing as the interior estimator (textured albedo,
    # material set), so f_in/f_out match what render_frame computes.
    settings = narrow_settings(scene, settings)
    tri1, corner = _on(table.tri1, device), _on(table.corner, device)

    with torch.no_grad():
        va, vb = edge_endpoints(scene, tri1, corner)
        is_sil, interior = silhouette_flags(scene, table, cam_d.position)
        # Drop edges with an endpoint at or behind the near plane (projection
        # undefined): a documented bias for geometry crossing the camera plane.
        usable = is_sil & (_clip_w(cam_d, va) > cam_d.near_clip) & (_clip_w(cam_d, vb) > cam_d.near_clip)
        chord = torch.linalg.norm(screen_xy(cam_d, vb) - screen_xy(cam_d, va), dim=-1)
        weight_e = torch.where(usable, chord, 0.0)
        total = weight_e.sum()
        if not total.item() > 0:  # no usable silhouette: the term is exactly 0
            return _zero_grads(params)

        k_pick, k_s, k_trace = threefry.split(key, 3)
        row_chunk = max(1, _GUMBEL_CHUNK_ELEMENTS // table.num_edges)
        pick = threefry.categorical(k_pick, _safe_logits(weight_e, total), shape=(n_samples,), row_chunk=row_chunk)
        q_pick = weight_e[pick] / maximum(total, 1e-30)  # per-edge probability
        s = threefry.uniform(k_s, (n_samples,))
        va_p, vb_p = va[pick], vb[pick]
        p_world = (1.0 - s[:, None]) * va_p + s[:, None] * vb_p

    # Screen tangent |dx_s/ds| (the exact perspective Jacobian by forward
    # mode) and the outward screen normal (away from the front owner).
    p_scr, t_scr = torch.func.jvp(lambda q: screen_xy(cam_d, q), (p_world,), (vb_p - va_p,))
    with torch.no_grad():
        t_len = torch.linalg.norm(t_scr, dim=-1)
        t_hat = t_scr / maximum(t_len, 1e-12)[:, None]
        int_tri = interior[pick]
        v0i = scene.v0[int_tri]
        pts_i = torch.stack([v0i, v0i + scene.e1[int_tri], v0i + scene.e2[int_tri]], dim=1)
        third = pts_i[torch.arange(n_samples, device=device), (corner[pick] + 2) % 3]
        to_third = screen_xy(cam_d, third) - p_scr
        perp = to_third - (to_third * t_hat).sum(-1, keepdim=True) * t_hat
        n_hat = -perp / maximum(torch.linalg.norm(perp, dim=-1, keepdim=True), 1e-12)

        # Radiance just inside (occluder side) and outside the silhouette.
        kt = threefry.key_data(k_trace)
        f_in = _trace_at_screen(scene, cam_d, settings, p_scr - eps_px * n_hat, kt, trace_spp)
        f_out = _trace_at_screen(scene, cam_d, settings, p_scr + eps_px * n_hat, kt, trace_spp)

        # Loss cotangent at each sample's pixel (box filter support = the pixel).
        h, w = cam_d.height, cam_d.width
        px = torch.floor(p_scr[:, 0]).to(torch.int64)
        py = torch.floor(p_scr[:, 1]).to(torch.int64)
        inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        cot = cot_image.to(device)[py.clamp(0, h - 1), px.clamp(0, w - 1)]
        cot = torch.where(inside[:, None], cot, 0.0)
        w_m = (cot * (f_in - f_out)).sum(-1) * t_len / maximum(q_pick, 1e-30) / n_samples
        w_m = torch.where(q_pick > 0, w_m, 0.0)
        tri1_p, corner_p = tri1[pick], corner[pick]

    def boundary_scalar(p):
        sc = scene_fn(p).to(device)
        cam_t = camera_fn(p).to(device) if camera_fn is not None else cam_d
        va_t, vb_t = edge_endpoints(sc, tri1_p, corner_p)
        xs = screen_xy(cam_t, (1.0 - s[:, None]) * va_t + s[:, None] * vb_t)
        return (w_m * (n_hat * xs).sum(-1)).sum()

    return _grad_of(boundary_scalar, params)


def shadow_edge_gradient(
    scene_fn,
    params,
    camera: Camera,
    settings: RenderSettings,
    cot_image: torch.Tensor,
    table: EdgeTable,
    key: torch.Tensor,
    n_samples: int = 512,
    eps: float = 1e-3,
    chunk: int = 128,
    clusters: EdgeClusters | None = None,
    specular_depth: int = 2,
    diffuse_depth: int = 1,
    camera_fn=None,
    device="cuda",
):
    """Boundary-term gradient from SHADOW silhouettes at the first diffuse
    vertex: the NEE visibility discontinuity.

    The direct-light integral at a shading point x,
    L(x) = ∫ (albedo/π)·Le·cosθ_x·V(x, ω) dω over the light's solid angle,
    jumps across blocker silhouettes as seen from x. As the primary
    estimator, in the unit-direction domain:

    1. sample camera pixels, trace the (detached) primary hit; follow up to
       ``specular_depth − 1`` mirror or glass bounces to the first diffuse
       vertex x (glass segments freeze one Fresnel reflect/transmit draw
       each, with the interior estimator's throughput);
    2. classify every edge's silhouette-ness against x (front ⊕ front wrt
       x, chunked by ``chunk`` points to bound the (M, E) intermediates);
    3. pick an edge ∝ direction-chord length, a point z on it;
    4. Δf between rays from x grazing either side of the edge, each traced
       one bounce: an emitter hit gives f = albedo/π·Le·cosθ_x, else 0;
    5. θ enters through ω(θ) = normalize(z(θ) − x(θ)); x(θ) is re-derived
       differentiably through the frozen ray/triangle chain (resolve_hits,
       reflect and refract per segment), so blockers, receivers and mirrors
       all carry gradient.

    Above ``_HIER_EDGE_THRESHOLD`` edges (or when ``clusters`` is passed)
    the two-level hierarchy (:class:`EdgeClusters`) picks the edges in
    O(M·C + M·cluster_size) instead of O(M·E): the same estimator.

    ``diffuse_depth=2`` adds the second diffuse vertex's shadow boundary:
    after x₁ the walk scatters one cosine-weighted sample with a detached
    direction to the next diffuse vertex x₂, edge-sampled as x₁ with
    throughput spec_tp·albedo₁; x₂(θ) is re-derived from x₁(θ) + ε·n₁(θ)
    along the frozen direction and triangles. ``camera_fn`` differentiates
    the camera: the primary rays are re-generated from ``camera_fn(params)``
    in ``boundary_scalar``.
    """
    device = resolve_device(device)
    key = key.to(device)
    scene, cam_d = _detached_inputs(scene_fn, params, camera, camera_fn, device)
    settings = narrow_settings(scene, settings)
    opts = _integrator_options(settings)
    intersect = make_intersect_fn(scene, opts)
    h_pix, w_pix = settings.height, settings.width
    mt = scene.materials
    m = n_samples

    # Specular-free scenes cannot extend the prefix past the first hit:
    # clamp the walk to one segment so they pay no extra search passes.
    live_types = mt.type[torch.unique(scene.mat_id[scene.valid])]
    if not bool(((live_types == BxdfType.MIRROR) | (live_types == BxdfType.GLASS)).any()):
        specular_depth = 1

    tri1, corner = _on(table.tri1, device), _on(table.corner, device)
    tri2, two = _on(table.tri2, device), _on(table.two_sided, device)
    up = torch.tensor([[0.0, 0.0, 1.0]], device=device).expand(m, 3)

    def albedo_at(attrs):
        if opts.textured:
            # Textured receivers: f uses the interior estimator's albedo.
            i = attrs.mat_id
            return textured_albedo(mt.albedo[i], mt.tex_kind[i], mt.tex_id[i], mt.checker_color[i],
                                   mt.checker_scale[i], attrs.uv, scene.textures)
        return mt.albedo[attrs.mat_id]

    def spec_walk(o0, d0, active0, kw):
        """Walk a specular (mirror/glass) prefix to the next diffuse vertex,
        recording the frozen chain of segments for ``rederive``. Returns
        (x, n_x, albedo, tp_mult, found_diffuse, segs)."""
        o_cur, d_cur, active = o0, d0, active0
        found = torch.zeros(m, dtype=torch.bool, device=device)
        xw, n_w = o0, up
        alb_w = torch.zeros((m, 3), device=device)
        tp = torch.ones((m, 3), device=device)
        segs = []
        for k in range(max(specular_depth, 1)):
            hit_k = intersect(o_cur, d_cur)
            a_k = resolve_hits(o_cur, d_cur, scene, hit_k.tri, need_uv=opts.textured)
            mat_k = mt.type[a_k.mat_id]
            facing_k = -torch.sign((d_cur * a_k.gn).sum(-1, keepdim=True))
            facing_k = torch.where(facing_k == 0.0, 1.0, facing_k)
            n_k = a_k.gn * facing_k
            newly = active & hit_k.hit & (mat_k == BxdfType.DIFFUSE)
            xw = torch.where(newly[:, None], a_k.point, xw)
            n_w = torch.where(newly[:, None], n_k, n_w)
            alb_w = torch.where(newly[:, None], albedo_at(a_k), alb_w)
            found = found | newly
            cont_m = active & hit_k.hit & (mat_k == BxdfType.MIRROR)
            is_glass = active & hit_k.hit & (mat_k == BxdfType.GLASS)
            # Fresnel-weighted reflect/refract: the integrator's glass rule
            # with one frozen draw per segment.
            cos_i = clip(-(d_cur * a_k.gn).sum(-1), -1.0, 1.0)
            entering = cos_i > 0.0
            ior = mt.refractive_index[a_k.mat_id]
            eta_i = torch.where(entering, 1.0, ior)
            eta_t = torch.where(entering, ior, 1.0)
            eta = eta_i / eta_t
            fres = fresnel_schlick(cos_i.abs(), eta_i, eta_t)
            refr_k, tir = refract(d_cur, n_k, eta[:, None])
            ug = threefry.uniform(threefry.fold_in(kw, k), (m,))
            choice_refl = tir | (ug < fres)
            cont_gr = is_glass & choice_refl
            cont_gt = is_glass & ~choice_refl
            cont = cont_m | cont_gr | cont_gt
            segs.append((hit_k.tri, newly, facing_k, cont_m, cont_gr, cont_gt, eta))
            tp_k = torch.where(
                cont_m[:, None], mt.specular_color[a_k.mat_id],
                torch.where(cont_gt[:, None], mt.transmittance_color[a_k.mat_id], 1.0),
            )
            tp = torch.where(cont[:, None], tp * tp_k, tp)
            d_new = torch.where(cont_gt[:, None], normalize_dir(refr_k), reflect(d_cur, n_k))
            d_cur = torch.where(cont[:, None], d_new, d_cur)
            off_n = torch.where(cont_gt[:, None], -n_k, n_k)
            o_cur = torch.where(cont[:, None], a_k.point + RAY_OFFSET * off_n, o_cur)
            active = cont
        return xw, n_w, alb_w, tp, found, segs

    def rederive(segs, o_t, d_t, sc):
        """Differentiable re-derivation of a frozen chain: each segment
        re-intersects its frozen triangle (resolve_hits); mirror and
        glass-reflect segments reflect, glass-transmit segments refract
        (frozen eta and branch) about the differentiable oriented normal.
        Returns (x_t, n_t) at the chain's diffuse stop."""
        x_t, n1_t = o_t, up
        for tri_k, stop_k, facing_k, m_k, gr_k, gt_k, eta_k in segs:
            a_t = resolve_hits(o_t, d_t, sc, tri_k, need_sn=False, need_uv=False)
            n_t = a_t.gn * facing_k
            x_t = torch.where(stop_k[:, None], a_t.point, x_t)
            n1_t = torch.where(stop_k[:, None], n_t, n1_t)
            cont_k = m_k | gr_k | gt_k
            refr_t, _ = refract(d_t, n_t, eta_k[:, None])
            d_new = torch.where(gt_k[:, None], normalize_dir(refr_t), reflect(d_t, n_t))
            off_n = torch.where(gt_k[:, None], -n_t, n_t)
            d_t = torch.where(cont_k[:, None], d_new, d_t)
            o_t = torch.where(cont_k[:, None], a_t.point + RAY_OFFSET * off_n, o_t)
        return x_t, n1_t

    def pick_edges(xr, kp):
        if clusters is not None:
            with scope("edges.pick_hierarchical"):
                return _pick_edges_hierarchical(scene, table, clusters, xr, va, vb, kp)
        # Flat per-(x, edge) silhouette classification and chord weights,
        # chunked to bound the (M, E) intermediates.
        g1, p1 = scene.gn[tri1], scene.v0[tri1]
        g2, p2 = scene.gn[tri2.clamp(min=0)], scene.v0[tri2.clamp(min=0)]
        boundary = (tri2 < 0)[None, :]
        picks, qs = [], []
        for c0 in range(0, m, chunk):
            xs = xr[c0 : c0 + chunk]
            f1 = torch.einsum("ek,cek->ce", g1, xs[:, None, :] - p1[None]) > 0
            f2 = torch.where(boundary, f1, torch.einsum("ek,cek->ce", g2, xs[:, None, :] - p2[None]) > 0)
            sil = torch.where(boundary, f1 | two[None, :], f1 != f2)
            chord_c = torch.linalg.norm(_unit(va[None] - xs[:, None]) - _unit(vb[None] - xs[:, None]), dim=-1) * sil
            total_c = chord_c.sum(-1, keepdim=True)
            pk = threefry.categorical(threefry.fold_in(kp, c0), _safe_logits(chord_c, total_c))
            q = chord_c.gather(-1, pk[:, None])[:, 0] / maximum(total_c[:, 0], 1e-30)
            picks.append(pk)
            qs.append(q)
        return torch.cat(picks), torch.cat(qs)

    def omega_of(zq, xq):
        return _unit(zq - xq)

    def f_sa(w_dir, xr, nr, albr):
        w_dir = _unit(w_dir)
        o2 = xr + RAY_OFFSET * nr
        h2 = intersect(o2, w_dir)
        a2 = resolve_hits(o2, w_dir, scene, h2.tri, need_sn=False, need_uv=False)
        le = mt.emissive_color[a2.mat_id] * mt.intensity[a2.mat_id][:, None]
        emit = h2.hit & (mt.type[a2.mat_id] == BxdfType.EMITTER)
        cosx = maximum((nr * w_dir).sum(-1), 0.0)
        return torch.where(emit[:, None], albr / math.pi * le * cosx[:, None], 0.0)

    with torch.no_grad():
        va, vb = edge_endpoints(scene, tri1, corner)  # (E,3) detached
        k_pix, k_jit, k_pick, k_s, k_d2, k_pick2, k_s2, k_gl = threefry.split(key, 8)
        pix = threefry.randint(k_pix, (m,), 0, h_pix * w_pix)
        jitter = threefry.uniform(k_jit, (m, 2))
        o, d = generate_rays_for_pixels(cam_d, pix, jitter)

        x, n_x, albedo, spec_tp, diffuse, segs1 = spec_walk(o, d, torch.ones(m, dtype=torch.bool, device=device), k_gl)

        # Optional second diffuse vertex (diffuse→diffuse shadow boundary):
        # one detached cosine-weighted scatter per sample, the interior
        # estimator's sampling measure, so weighting by albedo₁ matches its
        # bounce-2 term. The scatter ray runs the same specular walk.
        two_receivers = diffuse_depth >= 2 and settings.bounces >= 2
        if two_receivers:
            u2 = threefry.uniform(k_d2, (m, 2))
            d2_frozen = local_to_world(cosine_sample_hemisphere(u2[:, 0], u2[:, 1]), n_x)
            x2, n_x2, albedo2, tp2_mult, diffuse2, segs2 = spec_walk(
                x + RAY_OFFSET * n_x, d2_frozen, diffuse, threefry.fold_in(k_gl, 0x5EC2)
            )
            tp2 = spec_tp * albedo * tp2_mult

    if clusters is None and table.num_edges > _HIER_EDGE_THRESHOLD:
        clusters = build_edge_clusters(scene, table)

    cot = cot_image.to(device).reshape(-1, 3)[pix]

    def receiver_samples(xr, nr, albr, tpr, validr, kp, ks):
        """Detached boundary-sample data (pick, s, n̂, weight) for one
        receiver set: the per-receiver half of steps 2-4."""
        with torch.no_grad():
            pick, q_pick = pick_edges(xr, kp)
            s = threefry.uniform(ks, (m,))
            va_p, vb_p = va[pick], vb[pick]
            z = (1.0 - s[:, None]) * va_p + s[:, None] * vb_p
        omega, tau = torch.func.jvp(lambda zq: omega_of(zq, xr), (z,), (vb_p - va_p,))
        with torch.no_grad():
            t_len = torch.linalg.norm(tau, dim=-1)
            tau_hat = tau / maximum(t_len, 1e-12)[:, None]
            # Outward normal in the tangent plane at ω (away from the front owner).
            t1p = tri1[pick]
            f1_pick = (scene.gn[t1p] * (xr - scene.v0[t1p])).sum(-1) > 0
            int_tri = torch.where(f1_pick, t1p, tri2[pick].clamp(min=0))
            v0i = scene.v0[int_tri]
            pts_i = torch.stack([v0i, v0i + scene.e1[int_tri], v0i + scene.e2[int_tri]], dim=1)
            third = pts_i[torch.arange(m, device=device), (corner[pick] + 2) % 3]
            dir3 = omega_of(third, xr)
            v = dir3 - (dir3 * omega).sum(-1, keepdim=True) * omega
            v = v - (v * tau_hat).sum(-1, keepdim=True) * tau_hat
            n_hat = -v / maximum(torch.linalg.norm(v, dim=-1, keepdim=True), 1e-12)

            f_in = f_sa(omega - eps * n_hat, xr, nr, albr)
            f_out = f_sa(omega + eps * n_hat, xr, nr, albr)
            w_m = (cot * tpr * (f_in - f_out)).sum(-1) * t_len / maximum(q_pick, 1e-30) * (h_pix * w_pix) / m
            w_m = torch.where(validr & (q_pick > 0), w_m, 0.0)
        return {"tri1": tri1[pick], "corner": corner[pick], "s": s, "n_hat": n_hat, "w_m": w_m}

    r1 = receiver_samples(x, n_x, albedo, spec_tp, diffuse, k_pick, k_s)
    if two_receivers:
        r2 = receiver_samples(x2, n_x2, albedo2, tp2, diffuse2, k_pick2, k_s2)

    def boundary_scalar(p):
        sc = scene_fn(p).to(device)

        def term(r, x_t):
            va_t, vb_t = edge_endpoints(sc, r["tri1"], r["corner"])
            om = omega_of((1.0 - r["s"][:, None]) * va_t + r["s"][:, None] * vb_t, x_t)
            return (r["w_m"] * (r["n_hat"] * om).sum(-1)).sum()

        # Re-derive the receiver x(θ) through the frozen chains; with
        # camera_fn the primary rays re-derive from the differentiable camera.
        o_t, d_t = (o, d) if camera_fn is None else generate_rays_for_pixels(camera_fn(p).to(device), pix, jitter)
        x_t, n1_t = rederive(segs1, o_t, d_t, sc)
        total = term(r1, x_t)
        if two_receivers:
            # The scatter chain continues from x₁(θ) + ε·n₁(θ) along the
            # detached sampled direction through its own frozen segments.
            x2_t, _ = rederive(segs2, x_t + RAY_OFFSET * n1_t, d2_frozen, sc)
            total = total + term(r2, x2_t)
        return total

    return _grad_of(boundary_scalar, params)


def _add(a, b):
    if isinstance(a, torch.Tensor):
        return a + b
    return {k: a[k] + b[k] for k in a}


def value_and_grad_with_edges(
    image_loss,
    scene_fn,
    params,
    camera: Camera,
    settings: RenderSettings,
    table: EdgeTable,
    key: torch.Tensor,
    seed=None,
    n_samples: int = 1024,
    trace_spp: int = 4,
    shadow_edges: bool = False,
    shadow_samples: int = 512,
    shadow_clusters: EdgeClusters | None = None,
    specular_depth: int = 2,
    shadow_diffuse_depth: int = 1,
    camera_fn=None,
    device="cuda",
):
    """(loss, dL/dparams) with the interior term (autograd through
    ``render_frame``, detached sampling) plus the edge-sampled boundary
    terms: the complete first-order geometry gradient. ``shadow_edges=True``
    adds the NEE shadow-silhouette term (first diffuse vertex, through up to
    ``specular_depth − 1`` mirror or glass bounces;
    ``shadow_diffuse_depth=2`` adds the second diffuse vertex's term);
    ``shadow_clusters`` passes a prebuilt edge hierarchy (built on its own
    above _HIER_EDGE_THRESHOLD edges).

    ``image_loss(img) -> scalar``; ``scene_fn(params) -> TriangleScene``;
    ``camera_fn(params) -> Camera`` (optional) differentiates the camera
    too. The loss cotangent at the image (the gradient of ``image_loss``)
    weights both terms; the boundary terms draw from ``split(key)``.
    """
    device = resolve_device(device)
    key = key.to(device)
    leaves, flat = _leaves(params)
    with scope("edges.interior"), torch.enable_grad():
        cam = camera_fn(leaves) if camera_fn is not None else camera
        img = render_frame(scene_fn(leaves), cam, settings, seed=seed, device=device)
        img_d = img.detach().requires_grad_()
        loss = image_loss(img_d)
        cot = torch.autograd.grad(loss, img_d)[0]
        grads = [None] * len(flat)
        if img.requires_grad:
            grads = torch.autograd.grad(img, flat, grad_outputs=cot, allow_unused=True)
    total = _grads_like(params, flat, grads)
    k1, k2 = threefry.split(key)
    with scope("edges.primary"):
        total = _add(total, primary_edge_gradient(
            scene_fn, params, camera, settings, cot, table, k1, n_samples=n_samples, trace_spp=trace_spp,
            camera_fn=camera_fn, device=device,
        ))
    if shadow_edges:
        with scope("edges.shadow"):
            total = _add(total, shadow_edge_gradient(
                scene_fn, params, camera, settings, cot, table, k2, n_samples=shadow_samples,
                clusters=shadow_clusters, specular_depth=specular_depth, diffuse_depth=shadow_diffuse_depth,
                camera_fn=camera_fn, device=device,
            ))
    return loss.detach(), total
