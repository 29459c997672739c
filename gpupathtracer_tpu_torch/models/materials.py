"""Material model: the reference's BXDF family as an SoA table of tensors.

Counterpart of ``gpupathtracer_tpu/models/materials.py``. Besides the four
BXDF types, a diffuse albedo may come from a procedural checker or a
bilinear image lookup at the hit UV (``TEX_*`` kinds, ``textured_albedo``).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from gpupathtracer_tpu_torch.core.tensors import resolve_device, to_device


class BxdfType(enum.IntEnum):
    """Reference BXDFTyp enum order."""

    EMITTER = 0
    DIFFUSE = 1
    MIRROR = 2
    GLASS = 3


# Albedo texture kinds (tex_kind column).
TEX_NONE = 0  # flat albedo
TEX_CHECKER = 1  # procedural checker: albedo / checker_color, checker_scale
TEX_IMAGE = 2  # bilinear image lookup: scene.textures[tex_id]


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """SoA material parameters; row i = material id i."""

    type: torch.Tensor  # (M,) int64 — BxdfType
    albedo: torch.Tensor  # (M, 3) float32
    specular_color: torch.Tensor  # (M, 3)
    refractive_index: torch.Tensor  # (M,)
    emissive_color: torch.Tensor  # (M, 3)
    intensity: torch.Tensor  # (M,)
    transmittance_color: torch.Tensor  # (M, 3)
    tex_kind: torch.Tensor  # (M,) int64 — TEX_NONE / TEX_CHECKER / TEX_IMAGE
    tex_id: torch.Tensor  # (M,) int64 — row of scene.textures (TEX_IMAGE)
    checker_color: torch.Tensor  # (M, 3) — the checker's second color
    checker_scale: torch.Tensor  # (M,) — checker cells per unit UV

    def to(self, device) -> "MaterialTable":
        return to_device(self, device)


def material_table(materials: list[dict], device="cuda") -> MaterialTable:
    """Build a MaterialTable on ``device`` from a list of dicts (same keys
    and defaults as the JAX package's ``material_table``, texture keys
    included: ``"texture": "checker"`` with optional ``checker_color`` and
    ``checker_scale``, or ``"texture": "image"`` with ``texture_id``)."""
    device = resolve_device(device)
    n = len(materials)
    typ = np.zeros((n,), np.int64)
    albedo = np.zeros((n, 3), np.float32)
    specular = np.ones((n, 3), np.float32)
    ior = np.full((n,), 1.5, np.float32)
    emissive = np.zeros((n, 3), np.float32)
    intensity = np.zeros((n,), np.float32)
    transmit = np.ones((n, 3), np.float32)
    tex_kind = np.zeros((n,), np.int64)
    tex_id = np.full((n,), -1, np.int64)
    checker_color = np.zeros((n, 3), np.float32)
    checker_scale = np.zeros((n,), np.float32)
    for i, m in enumerate(materials):
        t = m["type"].upper() if isinstance(m.get("type"), str) else m.get("type", "DIFFUSE")
        typ[i] = int(BxdfType[t] if isinstance(t, str) else t)
        albedo[i] = np.asarray(m.get("albedo", (0.5, 0.5, 0.5)), np.float32)
        specular[i] = np.asarray(m.get("specular_color", (1.0, 1.0, 1.0)), np.float32)
        ior[i] = float(m.get("refractive_index", 1.5))
        emissive[i] = np.asarray(m.get("emissive_color", (0.0, 0.0, 0.0)), np.float32)
        intensity[i] = float(m.get("intensity", 0.0))
        transmit[i] = np.asarray(m.get("transmittance_color", (1.0, 1.0, 1.0)), np.float32)
        tex = m.get("texture", "none")
        if tex in ("checker", TEX_CHECKER):
            tex_kind[i] = TEX_CHECKER
            checker_color[i] = np.asarray(m.get("checker_color", 1.0 - albedo[i]), np.float32)
            checker_scale[i] = float(m.get("checker_scale", 8.0))
        elif tex in ("image", TEX_IMAGE):
            tex_kind[i] = TEX_IMAGE
            tex_id[i] = int(m.get("texture_id", 0))
        elif tex not in ("none", TEX_NONE, None):
            raise ValueError(f"unknown texture kind {tex!r}")
    t = lambda a: torch.as_tensor(a, device=device)
    return MaterialTable(
        type=t(typ),
        albedo=t(albedo),
        specular_color=t(specular),
        refractive_index=t(ior),
        emissive_color=t(emissive),
        intensity=t(intensity),
        transmittance_color=t(transmit),
        tex_kind=t(tex_kind),
        tex_id=t(tex_id),
        checker_color=t(checker_color),
        checker_scale=t(checker_scale),
    )


def textured_albedo(base, tex_kind, tex_id, checker_color, checker_scale, uv, textures):
    """Per-ray effective diffuse albedo (R, 3): a masked select over texture
    kinds, lanes without a texture keep ``base``.

    - TEX_CHECKER: ``base`` or ``checker_color`` on the parity of
      ``floor(u·s) + floor(v·s)``.
    - TEX_IMAGE: bilinear lookup into ``textures[tex_id]`` (T, H, W, 3) with
      wrap addressing and half-texel centers; v = 0 is the image's bottom
      row. Four gathers from the flattened texel table.
    """
    cu = torch.floor(uv[:, 0] * checker_scale)
    cv = torch.floor(uv[:, 1] * checker_scale)
    odd = torch.remainder(cu + cv, 2.0) >= 1.0
    checker = torch.where(odd[:, None], checker_color, base)
    out = torch.where((tex_kind == TEX_CHECKER)[:, None], checker, base)
    if textures is None:
        return out
    t_rows, th, tw = textures.shape[0], textures.shape[1], textures.shape[2]
    tid = torch.clamp(tex_id, 0, t_rows - 1)
    fu = uv[:, 0] * tw - 0.5
    fv = (1.0 - uv[:, 1]) * th - 0.5
    u0 = torch.floor(fu)
    v0 = torch.floor(fv)
    du = (fu - u0)[:, None]
    dv = (fv - v0)[:, None]
    x0 = torch.remainder(u0.to(torch.int64), tw)
    x1 = torch.remainder(x0 + 1, tw)
    y0 = torch.remainder(v0.to(torch.int64), th)
    y1 = torch.remainder(y0 + 1, th)
    flat = textures.reshape(t_rows * th * tw, 3)
    b = tid * (th * tw)
    texel = lambda i: flat.index_select(0, i)  # backward: index_add_ (see resolve_hits)
    c00 = texel(b + y0 * tw + x0)
    c01 = texel(b + y0 * tw + x1)
    c10 = texel(b + y1 * tw + x0)
    c11 = texel(b + y1 * tw + x1)
    bil = c00 * (1 - du) * (1 - dv) + c01 * du * (1 - dv) + c10 * (1 - du) * dv + c11 * du * dv
    return torch.where((tex_kind == TEX_IMAGE)[:, None], bil, out)


def no_hit_color(device="cuda") -> torch.Tensor:
    """The reference's miss color, pink (float32 (3,), on ``device``). The
    reference never writes it (misses stay black); a render config's
    ``background`` picks either behaviour."""
    return torch.tensor([1.0, 0.75, 0.79], dtype=torch.float32, device=resolve_device(device))
