"""The port's optimizers, schedule, grouping, clip and EMA against the JAX
package's optax transforms: the same numpy parameters and gradients go
through ``ddim_audio_tpu.training.optim`` and ``ddim_audio_tpu_torch.
training.optim`` for a few steps. Both compute in fp32 with the same order of
operations, so parameters and moments agree to rtol 1e-6 (one ulp or two of
fp32; norms and means sum in another order)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ddim_audio_tpu.config import load_config as jax_load_config
from ddim_audio_tpu.training import ema as jema
from ddim_audio_tpu.training import grouping as jgrouping
from ddim_audio_tpu.training import optim as joptim
from ddim_audio_tpu_torch.config import load_config
from ddim_audio_tpu_torch.training import ema, grouping, optim
from ddim_audio_tpu_torch.utils.tree import tree_leaves, tree_map, tree_paths

torch.set_num_threads(2)
CONFIG = "configs/audio_tiny.yml"


def _tree(rng, scale=1.0):
    def leaf(*shape):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    return {"transformer": {"dense": {"w": leaf(6, 5), "b": leaf(5)}},
            "temb": {"w": leaf(7, 3)},
            "down_modules": {"stages": [{"conv": {"w": leaf(3, 3, 2, 4)}},
                                        {"norm": {"g": leaf(4)}}]}}


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, ref, rtol=1e-6, atol=1e-9):
    ref = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
           jax.tree_util.tree_flatten_with_path(ref)[0]}
    got = {k: v.numpy() for k, v in tree_paths(got).items()}
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def test_noam_schedule_golden_values():
    sched, jsched = optim.noam_schedule(3e-4, 1000), joptim.noam_schedule(3e-4, 1000)
    # read at the count BEFORE the increment: step 0 runs at lr / warmup
    assert sched(0) == pytest.approx(3e-7, rel=1e-12)
    assert sched(999) == pytest.approx(3e-4, rel=1e-12)  # the peak
    assert sched(3999) == pytest.approx(1.5e-4, rel=1e-12)
    for step in (0, 1, 9, 999, 1000, 123456):
        count = torch.tensor(step, dtype=torch.int32)
        np.testing.assert_allclose(
            sched(count).numpy(), np.asarray(jsched(jnp.asarray(step, jnp.int32))),
            rtol=1e-6)
        assert sched(count).dtype == torch.float32


GROUPS = {
    "adabelief": dict(optimizer="AdaBelief", lr=3e-4, warmup=10,
                      weight_decay=1e-5, beta=[0.9, 0.999], eps=1e-8,
                      amsgrad=False, clip_step=None, norm_ord=2),
    "adabelief_amsgrad": dict(optimizer="AdaBelief", lr=3e-4, warmup=None,
                              weight_decay=0.0, beta=[0.9, 0.99], eps=1e-8,
                              amsgrad=True, clip_step=None, norm_ord=2),
    "adabelief_clip_step": dict(optimizer="AdaBelief", lr=3e-2, warmup=4,
                                weight_decay=1e-3, beta=[0.9, 0.999], eps=1e-8,
                                amsgrad=False, clip_step=0.01, norm_ord=2),
    "adabelief_clip_step_l1": dict(optimizer="AdaBelief", lr=3e-2, warmup=4,
                                   weight_decay=0.0, beta=[0.9, 0.999],
                                   eps=1e-8, amsgrad=False, clip_step=0.05,
                                   norm_ord=1),
    "adamw": dict(optimizer="AdamW", lr=5e-4, warmup=10, weight_decay=1e-4,
                  beta=[0.9, 0.998], eps=1e-6, amsgrad=False),
    "adamw_amsgrad": dict(optimizer="AdamW", lr=5e-4, warmup=10,
                          weight_decay=1e-4, beta=[0.9, 0.98], eps=1e-6,
                          amsgrad=True),
    "adam": dict(optimizer="Adam", lr=1e-3, warmup=None, weight_decay=1e-2,
                 beta=[0.9, 0.999], eps=1e-8, amsgrad=False),
    "adam_amsgrad": dict(optimizer="Adam", lr=1e-3, warmup=5, weight_decay=0.0,
                         beta=[0.8, 0.9], eps=1e-8, amsgrad=True),
    "rmsprop": dict(optimizer="RMSProp", lr=1e-3, warmup=None,
                    weight_decay=1e-2, eps=1e-8),
    "sgd": dict(optimizer="SGD", lr=1e-2, warmup=3),
}


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_group_optimizer_matches_optax(name):
    ns = SimpleNamespace(**GROUPS[name])
    rng = np.random.default_rng(len(name))
    params = _tree(rng)
    jtx, tx = joptim.build_group_optimizer(ns), optim.build_group_optimizer(ns)
    jp, tp = _to_jax(params), _to_torch(params)
    jstate, tstate = jtx.init(jp), tx.init(tp)
    for step in range(4):
        # a spread of magnitudes; step 2 repeats step 1 so that amsgrad's
        # running max is exercised on a shrinking second moment
        grads = _tree(np.random.default_rng(100 + min(step, 2) - (step == 2)),
                      scale=10.0 ** (1 - step))
        jupd, jstate = jtx.update(_to_jax(grads), jstate, jp)
        jp = optax.apply_updates(jp, jupd)
        tupd, tstate = tx.update(_to_torch(grads), tstate, tp)
        tp = optim.apply_updates(tp, tupd)
        _close(tp, jp)
    links = tstate if isinstance(tstate, list) else [tstate]
    jlinks = jstate if isinstance(tstate, list) else [jstate]
    assert len(links) == len(jlinks)
    for link, jlink in zip(links, jlinks):
        jfields = {f: getattr(jlink, f) for f in getattr(jlink, "_fields", ())
                   if getattr(jlink, f) is not None}
        assert set(link) == set(jfields), name  # what the checkpoint carries
        for field, value in link.items():
            if isinstance(value, torch.Tensor):
                np.testing.assert_allclose(value.numpy(),
                                           np.asarray(jfields[field]),
                                           rtol=1e-5, err_msg=field)
            else:
                _close(value, jfields[field], atol=1e-12)


def test_clip_by_global_norm_is_optax_rule():
    """Scale by max_norm / norm only when norm >= max_norm, with no epsilon
    (torch's clip_grad_norm_ divides by norm + 1e-6)."""
    rng = np.random.default_rng(0)
    for scale, clipped in ((1e-3, False), (10.0, True)):
        tree = _tree(rng, scale)
        got = optim.clip_by_global_norm(_to_torch(tree), 1.0)
        ref, _ = optax.clip_by_global_norm(1.0).update(_to_jax(tree), None)
        _close(got, ref)
        norm = float(optim.global_norm(got))
        assert (abs(norm - 1.0) < 1e-6) == clipped
        if not clipped:  # untouched, bit for bit
            for a, b in zip(tree_leaves(got), tree_leaves(_to_torch(tree))):
                assert torch.equal(a, b)


def test_grouping_and_all_params_clip_match_jax():
    config, jconfig = load_config(CONFIG), jax_load_config(CONFIG)
    params = _tree(np.random.default_rng(1))
    labels, groups = grouping.group_labels(config.optimization.optimizer,
                                           params)
    jlabels, jgroups = jgrouping.group_labels(jconfig.optimization.optimizer,
                                              params)
    assert sorted(groups) == sorted(jgroups) == ["default", "transformer"]
    assert labels == {"transformer": "transformer", "temb": "default",
                      "down_modules": "default"}
    assert all(set(jax.tree_util.tree_leaves(jlabels[k])) == {v}
               for k, v in labels.items())
    # both grad_norm groups list no top_level_name: everything clips together
    clip_labels, clip_groups = grouping.group_labels(
        config.optimization.grad_norm, params)
    assert set(clip_labels.values()) == {"default"}
    assert list(clip_groups) == ["default"]
    assert grouping.classify_top_level(config.optimization.grad_norm) == {}

    jtx = joptim.build_optimizer(jconfig.optimization, _to_jax(params))
    tx = optim.build_optimizer(config.optimization, _to_torch(params))
    jp, tp = _to_jax(params), _to_torch(params)
    jstate, tstate = jtx.init(jp), tx.init(tp)
    assert sorted(tstate["transformer"][0]["mu"]) == ["transformer"]
    assert sorted(tstate["default"]["mu"]) == ["down_modules", "temb"]
    for step, scale in enumerate((5.0, 1e-3, 0.3)):  # clipped, not, clipped
        grads = _tree(np.random.default_rng(50 + step), scale)
        jupd, jstate = jtx.update(_to_jax(grads), jstate, jp)
        jp = optax.apply_updates(jp, jupd)
        tupd, tstate = tx.update(_to_torch(grads), tstate, tp)
        tp = optim.apply_updates(tp, tupd)
        _close(tp, jp)
    np.testing.assert_allclose(
        tstate["default"]["update_norm"].numpy(),
        np.asarray(jstate[1].inner_states["default"].inner_state.update_norm),
        rtol=1e-5)


def test_ema_matches_jax():
    rng = np.random.default_rng(2)
    params, moved = _tree(rng), _tree(rng)
    shadow, jshadow = ema.ema_init(_to_torch(params)), jema.ema_init(_to_jax(params))
    tp = _to_torch(params)
    assert all(s is not p and torch.equal(s, p) for s, p in
               zip(tree_leaves(shadow), tree_leaves(tp)))  # copies, no aliases
    for _ in range(3):
        shadow = ema.ema_update(shadow, _to_torch(moved), 0.999)
        jshadow = jema.ema_update(jshadow, _to_jax(moved), 0.999)
    _close(shadow, jshadow, rtol=1e-6)
    assert ema.ema_apply(shadow) is shadow
