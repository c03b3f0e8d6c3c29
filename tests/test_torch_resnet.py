"""Parity of the port's ResNet (ray_tpu_torch.models.resnet) with the JAX
package's models/resnet.py on the same weights (the JAX trees carried
across by `params_from_numpy`) and the same seeded numpy images.

Cases: resnet18 at width 16 (CIFAR stem), resnet50 (bottleneck blocks)
at width 4, and resnet18 at width 8 with the ImageNet stem (7x7 stride-2
convolution and the 3x3 stride-2 max pool, where "SAME" pads 0 before
and 1 after on even sizes); 4 images of 32 x 32.

fp32: eval logits within 1e-5 of their largest magnitude; train logits
and the new batch-norm state (biased batch variance, m·old +
(1-m)·batch) within 1e-4 of each leaf's largest magnitude (normalised by
the statistics of 4 images); the loss within 1e-5 relative.
Gradients of the train-mode loss are held in float64 (JAX under
`jax.enable_x64`): at these widths train-mode batch norm over 4 images
is so ill-conditioned that each package's fp32 gradients stand up to 20%
of a leaf's largest magnitude away from its own float64 ones (resnet50
at width 4), so an fp32 comparison would test rounding, not the model.
In float64 the logits, state, loss and every gradient agree within 1e-6
(the JAX package rounds the pooled features to fp32 before its head in
either precision). The gradients of the eval-mode loss (batch norm on
its running statistics) are held in fp32 within 1e-4 of each leaf's
largest magnitude, and in float64 within 1e-6.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import resnet as tr

CASES = {"resnet18_w16": dict(depth="resnet18", width=16),
         "resnet50_w4": dict(depth="resnet50", width=4),
         "resnet18_w8_imagenet_stem": dict(depth="resnet18", width=8,
                                           small_inputs=False)}
TOL = {"float32": {"eval": 1e-5, "train": 1e-4, "state": 1e-4,
                   "loss": 1e-5, "eval_grads": 1e-4},
       "float64": {"eval": 1e-6, "train": 1e-6, "state": 1e-6, "loss": 1e-6,
                   "grads": 1e-6, "eval_grads": 1e-6}}


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.detach().numpy() if isinstance(
                v, torch.Tensor) else np.asarray(v))
    return out


def _close(got, want, rel):
    """Each leaf within rel x its largest magnitude."""
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want)
    for k in want:
        tol = rel * max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol,
                                   err_msg=k)


def _tensors(tree):
    return [t for k in sorted(tree) for t in (
        _tensors(tree[k]) if isinstance(tree[k], dict) else [tree[k]])]


def _rebuild(tree, it):
    return {k: _rebuild(tree[k], it) if isinstance(tree[k], dict)
            else next(it) for k in sorted(tree)}


def _jax_run(kw, params, state, x, labels, dtype):
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import resnet as jr

    jd = jnp.dtype(dtype)
    with jax.enable_x64(dtype == "float64"):
        p, s = (jax.tree.map(lambda a: jnp.asarray(a, jd), t)
                for t in (params, state))
        config = jr.ResNetConfig(**kw, dtype=jd)
        xs = jnp.asarray(x, jd)
        def eval_loss(p, s, xs):
            logits = jr.apply(p, s, xs, config, train=False)[0]
            return -jnp.mean(jnp.take_along_axis(
                jax.nn.log_softmax(logits), labels[:, None], axis=-1))

        run = jax.jit(lambda p, s, xs: (
            jr.apply(p, s, xs, config, train=False)[0],
            jr.apply(p, s, xs, config, train=True)[0],
            jax.value_and_grad(jr.loss_fn, has_aux=True)(
                p, s, {"image": xs, "label": labels}, config),
            jax.grad(eval_loss)(p, s, xs)))
        ev, train, ((loss, aux), grads), eval_grads = run(p, s, xs)
        out = {"eval": ev, "train": train, "eval_grads": eval_grads}
        out.update(loss=loss, state=aux["state"], grads=grads,
                   accuracy=aux["accuracy"])
        return jax.tree.map(np.asarray, out)


def _port_run(kw, params, state, x, labels, dtype):
    td = getattr(torch, dtype)
    p = tr.params_from_numpy(params, "cpu", td)
    s = tr.params_from_numpy(state, "cpu", td)
    config = tr.ResNetConfig(**kw, dtype=td)
    xs = torch.from_numpy(x).to(td)
    out = {"eval": tr.apply(p, s, xs, config, train=False)[0],
           "train": tr.apply(p, s, xs, config, train=True)[0]}
    leaves = [t.requires_grad_(True) for t in _tensors(p)]
    label = torch.from_numpy(labels).long()
    loss, aux = tr.loss_fn(p, s, {"image": xs, "label": label}, config)
    grads = torch.autograd.grad(loss, leaves)
    logits = tr.apply(p, s, xs, config, train=False)[0]
    eval_loss = -torch.log_softmax(logits, -1).gather(
        -1, label[:, None]).mean()
    out.update(loss=loss, state=aux["state"], accuracy=aux["accuracy"],
               grads=_rebuild(p, iter(grads)),
               eval_grads=_rebuild(p, iter(torch.autograd.grad(
                   eval_loss, leaves))))
    return out


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, cpu_jax):
    """Both packages' outputs in fp32 and float64 on one case."""
    import jax

    from ray_tpu.models import resnet as jr

    kw = CASES[request.param]
    params, state = (jax.tree.map(np.asarray, t) for t in jr.init(
        jr.ResNetConfig(**kw), jax.random.key(0)))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (4,)).astype(np.int32)
    return {dt: (_jax_run(kw, params, state, x, labels, dt),
                 _port_run(kw, params, state, x, labels, dt))
            for dt in TOL}


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_forward_and_batch_norm_state_equal_jax(case, dtype):
    want, got = case[dtype]
    for mode in ("eval", "train"):
        assert got[mode].shape == (4, 10)
        assert got[mode].dtype == getattr(torch, dtype)
        _close({"logits": got[mode]}, {"logits": want[mode]},
               TOL[dtype][mode])
    _close(got["state"], want["state"], TOL[dtype]["state"])


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_loss_and_gradients_equal_jax(case, dtype):
    want, got = case[dtype]
    np.testing.assert_allclose(got["loss"].item(), float(want["loss"]),
                               rtol=TOL[dtype]["loss"])
    assert got["accuracy"].item() == float(want["accuracy"])
    if "grads" in TOL[dtype]:
        _close(got["grads"], want["grads"], TOL[dtype]["grads"])
    _close(got["eval_grads"], want["eval_grads"], TOL[dtype]["eval_grads"])


def test_init_matches_jax_layout():
    """The port's init draws its own numbers into the JAX package's trees:
    same keys, shapes and dtypes, and the JAX scales (He-normal
    convolutions, unit batch-norm scales, running stats (0, 1))."""
    import jax

    from ray_tpu.models import resnet as jr

    for kw in CASES.values():
        jp, js = jr.init(jr.ResNetConfig(**kw), jax.random.key(0))
        tp, ts = tr.init(tr.ResNetConfig(**kw),
                         torch.Generator().manual_seed(0), device="cpu")
        for got, want in ((tp, jp), (ts, js)):
            got, want = _flat(got), _flat(want)
            assert set(got) == set(want)
            for k in want:
                assert got[k].shape == want[k].shape, k
                assert got[k].dtype == np.float32, k
        conv = tp["stem"]["conv"]
        std = (2.0 / (conv.shape[0] * conv.shape[1] * conv.shape[2])) ** 0.5
        assert abs(conv.std().item() - std) < 0.25 * std
        assert torch.equal(ts["stem"]["var"], torch.ones(kw["width"]))
        assert torch.equal(tp["stem"]["bn"]["scale"], torch.ones(kw["width"]))
