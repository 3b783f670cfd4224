"""The port's loss-landscape library (``msa_tts_tpu_torch/analysis/
landscapes.py``) against the JAX package's on a small nonlinear loss
over a dictionary of a matrix, a bias and a convolution kernel.  Every
random draw is the JAX package's, injected: the plane's directions,
the projecting tracker's bases and the perturbation metric's directions
(threefry cannot be drawn in torch).

Where the port differs on purpose, the JAX side is held on the input
where the two must still agree: ``LossPerturbations``' first call (the
JAX version repeats it on every later call; the port draws anew), its
``alpha`` after a change (against a JAX metric built with the new
value).  ``ExpectedReturn`` is the JAX version's, uncapped rollout
included.

Tolerances, float32 on both sides: losses 1e-6 relative (read
~1e-7), gradients, normalized directions and projections 1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msa_tts_tpu.analysis import landscapes as J
from msa_tts_tpu_torch.analysis import landscapes as T

RTOL, ATOL = 1e-6, 1e-6
X = np.random.default_rng(0).standard_normal((5, 4)).astype(np.float32)
Y = np.random.default_rng(1).standard_normal((5, 3)).astype(np.float32)


def _params(seed=2):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((3,)).astype(np.float32),
            "conv": rng.standard_normal((2, 3, 5)).astype(np.float32)}


def jloss(p):
    h = jnp.tanh(X @ p["w"].T + p["b"])
    return jnp.mean((h - Y) ** 2) + 0.1 * jnp.sum(jnp.sin(p["conv"]) ** 2)


def tloss(p):
    h = torch.tanh(torch.from_numpy(X) @ p["w"].T + p["b"])
    return (torch.mean((h - torch.from_numpy(Y)) ** 2)
            + 0.1 * torch.sum(torch.sin(p["conv"]) ** 2))


def _t(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("mode", ["filter", "layer", "model"])
def test_normalize_direction_matches_jax(mode):
    p, d = _params(), _params(7)
    ref = J.normalize_direction(_j(d), _j(p), mode)
    out = T.normalize_direction(_t(d), _t(p), mode)
    for k in p:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, rtol=0, err_msg=k)
    with pytest.raises(ValueError, match="normalization"):
        T.normalize_direction(_t(d), _t(p), "other")


@pytest.mark.parametrize("mode", ["filter", "layer", "model"])
def test_random_plane_matches_jax_on_its_directions(mode):
    p, key = _params(), jax.random.PRNGKey(3)
    ref = J.random_plane(jloss, _j(p), distance=2.0, steps=4,
                         normalization=mode, rng=key)
    k1, k2 = jax.random.split(key)
    dirs = tuple(_t(jax.device_get(J.tree_rand_like(k, _j(p))))
                 for k in (k1, k2))
    out = T.random_plane(tloss, _t(p), distance=2.0, steps=4,
                         normalization=mode, directions=dirs)
    assert out.shape == (4, 4) and np.ptp(out) > 1e-3
    np.testing.assert_allclose(out, ref, rtol=RTOL)
    # the port's own draws: a surface of the same shape, repeatable
    a = T.random_plane(tloss, _t(p), distance=2.0, steps=3, seed=5)
    assert np.array_equal(a, T.random_plane(tloss, _t(p), distance=2.0,
                                            steps=3, seed=5))


def test_paths_match_jax():
    p0, p1, c = _params(2), _params(3), _params(4)
    np.testing.assert_allclose(
        T.linear_interpolation(tloss, _t(p0), _t(p1), 7),
        J.linear_interpolation(jloss, _j(p0), _j(p1), 7), rtol=RTOL)
    np.testing.assert_allclose(
        T.bezier_path(tloss, _t(p0), _t(p1), _t(c), 6),
        J.bezier_path(jloss, _j(p0), _j(p1), _j(c), 6), rtol=RTOL)
    out = T.polygon_path(tloss, [_t(p0), _t(c), _t(p1)], 5)
    assert out.shape == (10,)
    np.testing.assert_allclose(
        out, J.polygon_path(jloss, [_j(p0), _j(c), _j(p1)], 5), rtol=RTOL)


def test_trajectories_match_jax(tmp_path):
    """Flattening in the JAX package's leaf order (sorted names), the
    full tracker's spilled positions, the projecting tracker on JAX's
    bases, and the distances from the start."""
    hist = [_params(s) for s in range(4)]
    np.testing.assert_allclose(
        T.trajectory_distances([_t(h) for h in hist]),
        J.trajectory_distances([_j(h) for h in hist]), rtol=RTOL)
    jf = J.FullTrajectoryTracker(str(tmp_path / "j"))
    tf = T.FullTrajectoryTracker(str(tmp_path / "t"))
    jp = J.ProjectingTrajectoryTracker(_j(hist[0]), jax.random.PRNGKey(1),
                                       n_bases=3)
    tp = T.ProjectingTrajectoryTracker(_t(hist[0]), bases=jp.A)
    for h in hist:
        jf.save_position(_j(h))
        tf.save_position(_t(h))
        jp.save_position(_j(h))
        tp.save_position(_t(h))
    for a, b in zip(tf.get_trajectory(), jf.get_trajectory()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tp.get_trajectory(), jp.get_trajectory()):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    assert tf.get_item(1).shape == (45,)
    with pytest.raises(IndexError):
        tf[4]
    with pytest.raises(ValueError, match="bases"):
        T.ProjectingTrajectoryTracker(_t(hist[0]), bases=jp.A[:-1])
    assert T.ProjectingTrajectoryTracker(_t(hist[0]), n_bases=2).A.shape \
        == (45, 2)


def test_loss_and_gradient_match_jax():
    p = _params()
    assert T.Loss(tloss)(_t(p)) == pytest.approx(J.Loss(jloss)(_j(p)),
                                                 rel=RTOL)
    g = T.LossGradient(tloss)(_t(p))
    assert g.shape == (45,)
    np.testing.assert_allclose(g, J.LossGradient(jloss)(_j(p)), atol=ATOL,
                               rtol=0)


def _jax_dirs(key, params, n):
    """The directions the JAX metric draws: one tree_rand_like per key of
    ``split(key, n)``."""
    return [_t(jax.device_get(J.tree_rand_like(k, _j(params))))
            for k in jax.random.split(key, n)]


def test_loss_perturbations_differ_from_jax_on_purpose():
    """First call: equal on JAX's directions.  The port's later calls
    draw fresh directions (JAX's repeat its first), and a changed alpha
    takes effect (JAX's keeps the value it first traced)."""
    p, key = _params(), jax.random.PRNGKey(5)
    jm = J.LossPerturbations(jloss, n_directions=3, alpha=0.1, rng=key)
    tm = T.LossPerturbations(tloss, n_directions=3, alpha=0.1)
    ref = jm(_j(p))
    dirs = _jax_dirs(key, p, 3)
    np.testing.assert_allclose(tm(_t(p), directions=dirs), ref, atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_array_equal(jm(_j(p)), ref)   # JAX repeats itself
    a, b = tm(_t(p)), tm(_t(p))
    assert a.shape == b.shape == (3,) and not np.allclose(a, b)
    tm.alpha = 0.5
    jm.alpha = 0.5
    np.testing.assert_array_equal(jm(_j(p)), ref)   # still alpha 0.1
    ref5 = J.LossPerturbations(jloss, n_directions=3, alpha=0.5,
                               rng=key)(_j(p))
    np.testing.assert_allclose(tm(_t(p), directions=dirs), ref5,
                               atol=ATOL, rtol=RTOL)
    tm.alpha = 0.0
    np.testing.assert_allclose(tm(_t(p)), 0.0, atol=1e-7)


class _Env:
    """A gym-style environment: the episode ends after ``n`` steps;
    reward = the action's sum."""

    def __init__(self, n):
        self.n, self.t = n, 0

    def reset(self):
        self.t = 0
        return np.ones(4, np.float32)

    def step(self, action):
        self.t += 1
        return (np.full(4, self.t, np.float32), float(np.sum(action)),
                self.t >= self.n, {})


def test_expected_return_matches_jax():
    p = _params()

    def jpol(params, obs):
        return jnp.tanh(params["w"] @ obs)

    def tpol(params, obs):
        return torch.tanh(params["w"] @ obs)

    ref = J.ExpectedReturn(_Env(5), jpol, n_episodes=2)(_j(p))
    out = T.ExpectedReturn(_Env(5), tpol, n_episodes=2)(_t(p))
    assert out == pytest.approx(ref, rel=RTOL)


def test_tree_rand_like_and_filter_norms():
    p = _t(_params())
    g = torch.Generator().manual_seed(0)
    d = T.tree_rand_like(g, p)
    assert list(d) == list(p)
    assert all(d[k].shape == p[k].shape and d[k].dtype == p[k].dtype
               for k in p)
    assert not torch.equal(d["w"], T.tree_rand_like(g, p)["w"])
    for k, v in _params().items():
        np.testing.assert_allclose(T._filter_norms(torch.as_tensor(v))
                                   .numpy(),
                                   np.asarray(J._filter_norms(
                                       jnp.asarray(v))), rtol=RTOL)
