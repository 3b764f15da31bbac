"""The port's adaptive AA (adaptive.py) against the JAX package and
against its own uniform AA.

JAX runs its XLA branch on the CPU, the port its plain loops
(`device="cpu"`). Criteria:
  * edge_score: bitwise equal to JAX's in float32 (the same float32
    operations in the same order), with and without a base image;
  * the refined pixel set: equal to JAX's `refined_idx`, in order. The
    scores hold many exact ties (every capture flip scores 1e6 plus a
    small gradient, flat regions 0), so this pins the tie rule of
    lax.top_k: ties in ascending index order;
  * render_shadow_adaptive: bitwise equal to the port's own
    render_shadow_aa at a 10 % budget, mirror on and off (refined pixels
    trace the uniform sample set; the others lie where every sample
    agrees);
  * render_scene_adaptive: bilinear image RMSE < 1e-3 against JAX's over
    every pixel (the winding < 2 rule of the uniform test is not needed
    at this scene's size).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from light_path_tracer_tpu import adaptive as jad
from light_path_tracer_tpu.utils.config import RenderConfig as JRender
from light_path_tracer_tpu.utils.config import SceneConfig as JScene
from light_path_tracer_tpu_torch import aa, adaptive
from light_path_tracer_tpu_torch.utils.config import RenderConfig, SceneConfig


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _base_pass(seed, shape=(20, 24)):
    """A synthetic base pass: a captured blob, winding bands, a smooth
    final-alpha field with a few exact ties."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    fa = (0.3 + 0.01 * xx + 0.02 * yy + 1e-3 * rng.random(shape))
    fa[(yy - 9) ** 2 + (xx - 11) ** 2 < 20] = np.nan
    fa[0, :5] = 0.5
    wind = ((xx // 7) % 3).astype(np.int32)
    return fa, wind


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("with_image", [False, True])
def test_edge_score_bitwise_matches_jax(dtype, with_image):
    fa, wind = _base_pass(0)
    fa = fa.astype(dtype)
    img = (np.random.default_rng(1).random(fa.shape + (3,))
           .astype(np.float32) if with_image else None)
    sj = jad.edge_score(jnp.asarray(fa), jnp.asarray(wind),
                        None if img is None else jnp.asarray(img))
    st = adaptive.edge_score(torch.from_numpy(fa), torch.from_numpy(wind),
                             None if img is None else torch.from_numpy(img))
    assert st.dtype == torch.float32
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (st.numpy() >= 1e6).any() and (st.numpy() < 1.0).any()


def test_edge_score_grayscale_image_and_ranks():
    fa, wind = _base_pass(2)
    gray = np.random.default_rng(3).random(fa.shape).astype(np.float32)
    sj = jad.edge_score(jnp.asarray(fa), jnp.asarray(wind), jnp.asarray(gray))
    st = adaptive.edge_score(torch.from_numpy(fa), torch.from_numpy(wind),
                             torch.from_numpy(gray))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    score = adaptive.edge_score(torch.from_numpy(fa), torch.from_numpy(wind))
    # A pixel beside the captured blob outranks every winding edge.
    assert float(score[9, 6]) >= 1e6 > float(score[0, 6]) >= 1e3


def test_top_k_takes_ties_in_index_order():
    score = torch.tensor([0.0, 5.0, 1.0, 5.0, 5.0, 0.0, 1.0])
    np.testing.assert_array_equal(adaptive._top_k(score, 5).numpy(),
                                  [1, 3, 4, 2, 6])
    import jax
    np.testing.assert_array_equal(
        np.asarray(jax.lax.top_k(jnp.asarray(score.numpy()), 5)[1]),
        [1, 3, 4, 2, 6])


@pytest.mark.parametrize("mirror", [True, False])
def test_shadow_adaptive_refines_jax_pixels(mirror):
    res = (24, 32)
    img_j, st_j = jad.render_shadow_adaptive(
        JScene(M=1.0, a=0.9), res, JRender(use_tb_symmetry=mirror),
        aa_samples=4, refine_frac=0.05)
    img_t, st_t = adaptive.render_shadow_adaptive(
        SceneConfig(M=1.0, a=0.9), res, RenderConfig(use_tb_symmetry=mirror),
        aa_samples=4, refine_frac=0.05, device="cpu")
    np.testing.assert_array_equal(st_t["refined_idx"].numpy(),
                                  np.asarray(st_j["refined_idx"]))
    assert (img_t.numpy() == np.asarray(img_j)).mean() >= 0.99
    for key in ("total_rays", "traced_rays", "uniform_aa_rays",
                "refined_pixels", "edge_pixels", "tb_symmetry"):
        assert st_t[key] == st_j[key], key


@pytest.mark.parametrize("mirror", [True, False])
def test_shadow_adaptive_equals_own_uniform_aa(mirror):
    scene, cfg = SceneConfig(M=1.0, a=0.9), RenderConfig(
        use_tb_symmetry=mirror)
    img_u, _ = aa.render_shadow_aa(scene, (32, 32), cfg, aa_samples=4,
                                   device="cpu")
    img_a, st = adaptive.render_shadow_adaptive(
        scene, (32, 32), cfg, aa_samples=4, refine_frac=0.10, device="cpu")
    assert torch.equal(img_a, img_u)
    assert st["refined_pixels"] == int(0.10 * 32 * 32)
    assert st["traced_rays"] < st["uniform_aa_rays"] / 2


def test_shadow_adaptive_schwarzschild_equals_uniform():
    scene, cfg = SceneConfig(M=1.0), RenderConfig()
    img_u, _ = aa.render_shadow_aa(scene, (24, 24), cfg, aa_samples=3,
                                   device="cpu")
    img_a, _ = adaptive.render_shadow_adaptive(
        scene, (24, 24), cfg, aa_samples=3, refine_frac=0.2, device="cpu")
    assert torch.equal(img_a, img_u)


def test_scene_adaptive_matches_jax():
    src = np.random.default_rng(0).random((24, 32, 3)).astype(np.float32)
    img_j, st_j = jad.render_scene_adaptive(
        JScene(M=1.0, a=0.9), src, JRender(sampling="bilinear"),
        aa_samples=4, refine_frac=0.1)
    img_t, st_t = adaptive.render_scene_adaptive(
        SceneConfig(M=1.0, a=0.9), src, RenderConfig(sampling="bilinear"),
        aa_samples=4, refine_frac=0.1, device="cpu")
    np.testing.assert_array_equal(st_t["refined_idx"].numpy(),
                                  np.asarray(st_j["refined_idx"]))
    assert st_t["edge_pixels"] == st_j["edge_pixels"]
    img_t = img_t.numpy()
    assert img_t.shape == src.shape and img_t.dtype == np.float32
    rmse = float(np.sqrt(((img_t - np.asarray(img_j)) ** 2).mean()))
    assert rmse < 1e-3


def test_scene_adaptive_grayscale_schwarzschild():
    src = np.random.default_rng(1).random((16, 16)).astype(np.float32)
    img, st = adaptive.render_scene_adaptive(
        SceneConfig(M=1.0), src, RenderConfig(), aa_samples=2,
        refine_frac=0.1, device="cpu")
    assert img.shape == (16, 16) and bool(torch.isfinite(img).all())
    assert st["traced_rays"] == 256 + 25


def test_adaptive_needs_two_samples():
    with pytest.raises(ValueError, match="aa_samples >= 2"):
        adaptive.render_shadow_adaptive(SceneConfig(a=0.9), (8, 8),
                                        aa_samples=1, device="cpu")
    with pytest.raises(ValueError, match="aa_samples >= 2"):
        adaptive.render_scene_adaptive(SceneConfig(a=0.9),
                                       np.zeros((8, 8, 3)), aa_samples=1,
                                       device="cpu")
