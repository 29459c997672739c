"""The decision product's precision modes of the port's four searches
against the JAX package: ``resolve_precision``, the ``kernel_precision``
setting and TOML key, "high" and "mixed" on the resident and streamed
routes against ``intersect_pallas``/``intersect_pallas_occluded``
(interpret mode, the same mode), "mixed"'s exact t, "default" against a
numpy model of one bf16 pass (the JAX CPU backend runs its "default" in
f32), and one small frame at "mixed" against the JAX package's.

Bars: the hit bar of tests_tpu/test_onchip.py (at least 99.95% of rays on
the same triangle, t to rtol = atol = 1e-5) and at least 99.95% of flags
equal. The two packages split their operands into the same bf16 values and
a product of two bf16 values is exact in f32, so only the order of each
f32 sum differs. The searches against the JAX package's run on the JAX
package's packed w (``same_w``): the two packs agree to 1e-6
(test_torch_intersect.py), and a 1-ulp difference in w can move its bf16
lo half by one of its ulps, which "high" turns into a t difference of
order 1e-5 at small t."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_intersect import HIT_AGREE, assert_hit_bar, random_scene, to_port
from test_torch_render import _resized, assert_image_bar
from test_torch_stream import force_streamed, is_streamed

from gpupathtracer_tpu.ops import pallas_intersect as jpi
from gpupathtracer_tpu.render.renderer import RenderSettings as JSettings
from gpupathtracer_tpu.render.renderer import render_frame as j_render
from gpupathtracer_tpu.utils.config import load_config as j_load_config
from gpupathtracer_tpu.utils.config import parse_config as j_parse_config
from gpupathtracer_tpu_torch.ops import packed_intersect as tpi
from gpupathtracer_tpu_torch.ops.plucker import K, NSCALARS, pack_rays
from gpupathtracer_tpu_torch.render import integrator as t_integrator
from gpupathtracer_tpu_torch.render.renderer import RenderSettings, _integrator_options, render_frame
from gpupathtracer_tpu_torch.utils.config import load_config, parse_config

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes")
MODES = ("auto", "highest", "high", "mixed", "default")
TB = 64


@pytest.fixture(scope="module")
def case():
    """A random scene (one- and two-sided triangles and a plane), 600 rays
    through it, their cutoffs for the any-hit searches (half of them inside
    the nearest hit), and the port's scene."""
    js, o, d = random_scene(seed=12, pad=128, rays=600)
    rng = np.random.default_rng(5)
    max_t = rng.uniform(0.0, 12.0, o.shape[0]).astype(np.float32)
    max_t[rng.uniform(size=o.shape[0]) < 0.1] = 0.0
    return js, to_port(js), o, d, max_t


def same_w(jp, tp):
    """The port's pack ``tp`` with the JAX package's packed w of ``jp``,
    marked ``live_slots_only`` once its zeros are checked."""
    return tpi.mark_live_slots(dataclasses.replace(tp, w=torch.tensor(np.asarray(jp.w)), live_slots_only=False))


def test_resolve_precision():
    assert tpi.resolve_precision("auto") == jpi.resolve_precision("auto") == "highest"
    for mode in tpi.PRECISIONS:
        assert tpi.resolve_precision(mode) == mode
    with pytest.raises(ValueError, match="'highest', 'high', 'mixed', 'default'"):
        tpi.resolve_precision("bf16")
    with pytest.raises(ValueError, match="unknown precision"):
        tpi.intersect_packed(torch.zeros((1, 3)), torch.ones((1, 3)), None, precision="fast")


@pytest.mark.parametrize("mode", MODES)
def test_kernel_precision_setting_and_toml_key(mode, tmp_path):
    """``RenderSettings(kernel_precision=...)`` and the TOML key reach the
    integrator's options, as in the JAX package (before the port took the
    field, the constructor raised TypeError and the loader dropped the
    key)."""
    st = RenderSettings(kernel_precision=mode)
    assert st.kernel_precision == mode
    assert _integrator_options(st).kernel_precision == mode
    src = open(os.path.join(SCENES, "config3_icosphere.toml")).read()
    path = tmp_path / "scene.toml"
    path.write_text(src.replace("[render]\n", f'[render]\nkernel_precision = "{mode}"\n', 1))
    t_settings = parse_config(load_config(str(path)), SCENES)[3]
    j_settings = j_parse_config(j_load_config(str(path)), SCENES)[3]
    assert t_settings.kernel_precision == j_settings.kernel_precision == mode
    assert JSettings(kernel_precision=mode).kernel_precision == mode


def test_the_searches_take_the_options_precision(case):
    """The kernel route's searches get ``kernel_precision``; the plain
    intersector computes in f32, as the JAX package's plucker search does;
    an unknown mode raises before anything is searched."""
    _, ts, _, _, _ = case
    packed = tpi.pack_scene(ts, tri_block=TB)
    for intersector, want in (("auto", "high"), ("pallas", "high"), ("plucker", "highest")):
        opts = t_integrator.IntegratorOptions(intersector=intersector, kernel_precision="high", tri_block=TB)
        fn = t_integrator.make_intersect_fn(ts, opts, packed=packed)
        occ = t_integrator.make_occlusion_fn(ts, opts, fn, packed=packed, use_kernel=True)
        assert fn.keywords["precision"] == occ.keywords["precision"] == want
    with pytest.raises(ValueError, match="unknown precision"):
        t_integrator.check_supported(t_integrator.IntegratorOptions(kernel_precision="float16"))


@pytest.mark.parametrize("streamed", [False, True], ids=["resident", "streamed"])
@pytest.mark.parametrize("mode", ["high", "mixed"])
def test_closest_hit_matches_pallas_at_precision(case, mode, streamed, monkeypatch):
    if streamed:
        force_streamed(monkeypatch, cluster_bytes=64 * 1024)
    js, ts, o, d, _ = case
    jp, tp = jpi.pack_scene(js, tri_block=TB), tpi.pack_scene(ts, tri_block=TB)
    assert is_streamed(tp) == streamed
    tp = same_w(jp, tp)
    jh = jpi.intersect_pallas(jnp.asarray(o), jnp.asarray(d), jp, interpret=True, precision=mode)
    th = tpi.intersect_packed(torch.as_tensor(o), torch.as_tensor(d), tp, precision=mode)
    assert np.asarray(jh.hit).mean() > 0.2
    assert_hit_bar(th, jh.t, jh.tri, jh.hit)


@pytest.mark.parametrize("streamed", [False, True], ids=["resident", "streamed"])
@pytest.mark.parametrize("mode", ["high", "mixed"])
def test_occluded_matches_pallas_at_precision(case, mode, streamed, monkeypatch):
    if streamed:
        force_streamed(monkeypatch, cluster_bytes=64 * 1024)
    js, ts, o, d, max_t = case
    jp, tp = jpi.pack_scene(js, tri_block=TB), tpi.pack_scene(ts, tri_block=TB)
    tp = same_w(jp, tp)
    want = np.asarray(jpi.intersect_pallas_occluded(jnp.asarray(o), jnp.asarray(d), jnp.asarray(max_t), jp,
                                                    interpret=True, precision=mode))
    got = tpi.intersect_packed_occluded(torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(max_t), tp,
                                        precision=mode).numpy()
    assert 0.05 < want.mean() < 0.95
    assert (got == want).mean() >= HIT_AGREE
    assert not got[max_t == 0].any()


@pytest.mark.parametrize("streamed", [False, True], ids=["resident", "streamed"])
def test_mixed_t_equals_highest_where_the_triangle_agrees(case, streamed, monkeypatch):
    """"mixed" computes D|num, and so t, exactly as "highest" does (the JAX
    package's test_mixed_precision_mode_exact_t_near_parity); "high" keeps
    JAX's near-parity bar (99.5% of triangles, t to 1e-2)."""
    if streamed:
        force_streamed(monkeypatch, cluster_bytes=64 * 1024)
    _, ts, o, d, _ = case
    tp = tpi.pack_scene(ts, tri_block=TB)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    exact = tpi.intersect_packed(o, d, tp)
    for mode in ("mixed", "high"):
        h = tpi.intersect_packed(o, d, tp, precision=mode)
        agree = h.tri == exact.tri
        assert agree.double().mean() > 0.995
        same = agree & exact.hit
        if mode == "mixed":
            assert torch.equal(h.t[same], exact.t[same])
        else:
            torch.testing.assert_close(h.t[same], exact.t[same], rtol=1e-2, atol=1e-2)


def _bf16(x: np.ndarray) -> np.ndarray:
    """float32 rounded to bf16 (to nearest, ties to even), as float32."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
    return b.astype(np.uint32).view(np.float32)


def test_default_matches_a_numpy_model_of_one_bf16_pass(case):
    """"default": both operands rounded to bf16, the products summed in f32.
    The decision scalars of a block against numpy's, then the whole search
    against a dense numpy search over every packed row at the hit bar (the
    search visits blocks front to back and exits early, and its entry bounds
    bound the exact t, not the bf16 one)."""
    _, ts, _, _, _ = case
    rng = np.random.default_rng(9)
    o = (rng.normal(size=(3000, 3)) * 4).astype(np.float32)
    d = rng.normal(size=(3000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tp = tpi.pack_scene(ts, tri_block=TB)
    feats = pack_rays(torch.as_tensor(o), torch.as_tensor(d))
    w = tp.w.numpy()
    nb = w.shape[0]
    # (R, K) x (K, nb * 5 * tb): every packed row's five scalars.
    wf = w.transpose(1, 0, 2).reshape(K, -1)
    s_np = (_bf16(feats.numpy()).astype(np.float64) @ _bf16(wf).astype(np.float64)).astype(np.float32)
    blk = torch.arange(nb)
    s_port = tpi._decision_scalars(feats[None].expand(nb, -1, -1), tp.w, blk, TB, "default")
    s_port = torch.stack(s_port, 2).permute(1, 0, 2, 3).reshape(feats.shape[0], -1).numpy()
    np.testing.assert_allclose(s_port, s_np, rtol=1e-5, atol=1e-4)
    s0, s1, s2, dd, num = (s_np.reshape(-1, nb, NSCALARS, TB)[:, :, k].reshape(-1, nb * TB) for k in range(NSCALARS))
    with np.errstate(divide="ignore", invalid="ignore"):
        ok = (np.maximum(np.maximum(s0, s1), s2) <= 0) & (dd <= -1e-6) & (num < np.float32(1e-6) * dd)
        t = np.where(ok, num / dd, np.float32(3.0e38)).astype(np.float32)
    row = t.argmin(axis=1)
    t_min = t[np.arange(t.shape[0]), row]
    hit = t_min < np.float32(3.0e38)
    tri = np.where(hit, tp.tri_map.numpy()[row], -1)
    h = tpi.intersect_packed(torch.as_tensor(o), torch.as_tensor(d), tp, precision="default")
    assert hit.mean() > 0.2
    assert_hit_bar(h, np.where(hit, t_min, 3.0e38), tri, hit)


def test_streamed_operands_are_split_once_per_pack(case, monkeypatch):
    """The K3 and the K4 search of one pack at "high" stage one split. The
    streamed route pads a pack whose block count is no multiple of its
    blocks per cluster; the padded w is made once per pack, and both
    searches take their bf16 operands from the one split cached on it. An
    in-place edit of w makes the padded w and the split anew. The wrappers'
    staging is watched with the launch replaced (there is no card here)."""
    _, ts, o, d, max_t = case
    tp = tpi.pack_scene(ts, tri_block=TB)
    tp = dataclasses.replace(tp, w=tp.w.clone())
    nb = tp.w.shape[0]
    bpc = nb - 1
    assert nb > 2 and nb % bpc
    monkeypatch.setattr(tpi, "CLUSTER_TARGET_BYTES", bpc * K * NSCALARS * TB * 4)
    staged = []
    monkeypatch.setattr(tpi, "_kernel_device", lambda feats, name: feats.device)
    monkeypatch.setattr(tpi._build, "launch", lambda library, fn, dev, *args: staged.append((library, args)))
    o, d, max_t = (torch.as_tensor(x) for x in (o, d, max_t))

    def operands():
        """(w, hi, lo) that K3 and then K4 stage at "high"."""
        staged.clear()
        tpi.closest_hit_streamed(*tpi.prepare_rays_streamed(o, d, tp), tpi.STREAM_RAY_TILE, precision="high")
        tpi.occluded_streamed(*tpi.prepare_shadow_rays_streamed(o, d, max_t, tp), tpi.STREAM_RAY_TILE,
                              precision="high")
        (k3, t3), (k4, t4) = staged
        assert (k3, k4) == ("closest_hit_streamed", "occlusion_streamed")
        return t3[7:10], t4[5:8]

    k3, k4 = operands()
    w, hi, lo = k3
    assert all(a is b for a, b in zip(k3, k4))
    assert w.shape[0] == 2 * bpc and torch.equal(w[:nb], tp.w) and not w[nb:].any()
    assert hi.dtype == lo.dtype == torch.bfloat16 and lo is not hi
    assert w._kernel_operands[1] is hi and w._kernel_operands[2] is lo  # the one split on w
    again = operands()
    assert all(a is b for a, b in zip(again[0] + again[1], k3 + k4))
    tp.w.mul_(1.0)
    edited = operands()
    assert all(a is b for a, b in zip(edited[0], edited[1]))
    assert all(a is not b for a, b in zip(edited[0], k3))
    assert all(torch.equal(a, b) for a, b in zip(edited[0], k3))


def test_render_at_mixed_matches_jax():
    """One small frame of the config 3 stand-in at kernel_precision="mixed"
    against the JAX package's (intersector "pallas", interpret mode off the
    TPU), at the image bar."""
    (js, jc, jst), (ts_, tc, tst) = _resized("config3_icosphere.toml", 32, 1)
    jst = dataclasses.replace(jst, bounces=2, kernel_precision="mixed")
    tst = dataclasses.replace(tst, bounces=2, kernel_precision="mixed")
    want = np.asarray(j_render(js, jc, jst))
    got = render_frame(ts_, tc, tst, device="cpu").numpy()
    assert got.shape == want.shape and want.mean() > 0.05
    assert_image_bar(got, want)
