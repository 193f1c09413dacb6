"""The port's Mamba modules (``nn/mamba.py``) and the ``mamba`` grammar
against the JAX package's, on the CPU in f32, weights bridged from
randomised JAX variables.

Tolerances (f32 on both sides):
  * the modules and the recurrence: max |port - JAX| within 1e-5 of
    max(1, max |JAX|).  JAX's associative scan and the port's Hillis-Steele
    scan multiply and add the same terms in another order, as do the two
    sides' matmuls; the error of a sum scales with its terms, so the gate
    is relative to the output's range;
  * the O(1) step functions: the same gate against JAX's step functions
    and against the port's own parallel forward over the same tokens;
  * ``yolov5s_mamba`` at 64 px (``test_torch_port_mamba_model.py``):
    predictions and raw outputs at rtol 1e-4, atol 1e-4
    (``tests/test_torch_port_detector.py``'s f32 gate), each MambaFusion
    level's two outputs within 1e-4 of their range;
  * the train step: a one-level mamba model (the dryrun grammar with its
    GPT row as MambaFusion; JAX compiles ``yolov5s_mamba``'s step in about
    a minute on the CPU, this one in about 20 s), two steps at lr0 1e-3
    (the first at the weights' warmup lr 0), each tensor's change within
    5% of JAX's (``tests/test_torch_port_train.py``'s gate); at that lr the
    Mamba leaves move by less than their f32 spacing, so the SGD momentum
    buffers (the summed gradients plus decay) are held too, each tensor
    within 1e-3 of its own largest value (measured: 1.8e-4 at most, on a
    BN scale; the Mamba leaves lower)."""

import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mmidet_tpu.losses.detection import LossHyp as JaxLossHyp
from mmidet_tpu.models.detector import TwoStreamDetector as JaxDetector
from mmidet_tpu.models.spec import LayerDef as JaxLayerDef
from mmidet_tpu.models.zoo import dryrun_spec as jax_dryrun_spec
from mmidet_tpu.models.zoo import get_model_spec as jax_get_spec
from mmidet_tpu.nn import mamba as jm
from mmidet_tpu.train import optimizer as jopt
from mmidet_tpu.train import schedule as jsched
from mmidet_tpu.train.step import init_state as jax_init_state
from mmidet_tpu.train.step import make_train_step as jax_make_train_step
from mmidet_tpu_torch.bridge import from_jax_variables, torch_key
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models import spec as pspec
from mmidet_tpu_torch.models.spec import LayerDef
from mmidet_tpu_torch.models.zoo import dryrun_spec, get_model_spec
from mmidet_tpu_torch.nn import mamba as pm
from mmidet_tpu_torch.train import optimizer as popt
from mmidet_tpu_torch.train import schedule as psched
from mmidet_tpu_torch.train.step import init_state, make_train_step

from test_torch_port_layers import _Holder
from test_torch_port_train import (_anchors, _batch, _check_moves,  # noqa
                                   _seeded, _threads, _to_torch)

REL_TOL = 1e-5
GRAD_TOL = 1e-3
D, L = 24, 40                   # module tests: d_model, tokens


def _close(got, want, tol=REL_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


def _tokens(shape, seed=1):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 128, 5, 3), (3, 37, 4), (1, 1, 2)])
def test_linear_recurrence_matches_jax_and_the_loop(shape):
    rng = np.random.default_rng(len(shape))
    a = rng.uniform(0.0, 1.0, shape).astype(np.float32)
    x = rng.normal(0, 1, shape).astype(np.float32)
    got = pm.linear_recurrence(torch.from_numpy(a), torch.from_numpy(x))
    _close(got, jax.jit(jm.linear_recurrence)(a, x))
    h, loop = np.zeros(shape[:1] + shape[2:], np.float64), []
    for t in range(shape[1]):
        h = a[:, t] * h + x[:, t]
        loop.append(h)
    _close(got, np.stack(loop, 1))


def _variables(jmod, *args, seed=0):
    """Variables of the shapes JAX's init gives (``eval_shape``: a traced
    init costs seconds a module), drawn around its init: Dense kernels
    N(0, 1/fan-in), ``A_log`` log(1..d_state) and ``D`` and the RMSNorm
    weights 1, each + N(0, 0.1), the depthwise conv U(+-0.5), the rest
    N(0, 0.1)."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = rng.normal(0, np.sqrt(1.0 / leaf.shape[0]), leaf.shape)
        elif name == "A_log":
            v = np.log(np.arange(1, leaf.shape[1] + 1)) + rng.normal(
                0, 0.1, leaf.shape)
        elif name in ("D", "weight"):
            v = 1.0 + rng.normal(0, 0.1, leaf.shape)
        elif name == "conv1d_kernel":
            v = rng.uniform(-0.5, 0.5, leaf.shape)
        else:
            v = rng.normal(0, 0.1, leaf.shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(fill, dict(jax.eval_shape(
        jmod.init, jax.random.PRNGKey(0), *args)))


def _cfg(n_layers=2):
    return jm.MambaConfig(d_model=D, n_layers=n_layers)


def _pair(name):
    """A JAX module, its randomised variables and the port module with
    them (at ``model.0``)."""
    jmod = getattr(jm, name)(_cfg())
    pmod = getattr(pm, name)(pm.MambaConfig(D, 2))
    v = _variables(jmod, _tokens((1, L, D)))
    from_jax_variables(_Holder(pmod), {c: {"l0_m": t} for c, t in v.items()})
    return jmod, v, pmod.eval()


@pytest.mark.parametrize("name", ["MambaBlock", "ResidualBlock", "Mamba"])
def test_mamba_modules_match_jax(name):
    jmod, v, pmod = _pair(name)
    x = _tokens((2, L, D))
    with torch.no_grad():
        _close(pmod(torch.from_numpy(x)), jax.jit(jmod.apply)(v, x))


def test_mamba_fusion_matches_jax():
    rgb, ir = _tokens((2, 20, 24, D)), _tokens((2, 20, 24, D), 2)
    jmod = jm.MambaFusion(D)
    v = _variables(jmod, rgb[:1], ir[:1])
    pmod = pm.MambaFusion(D)
    used = from_jax_variables(_Holder(pmod),
                              {c: {"l0_m": t} for c, t in v.items()})
    assert used["model.0.bwd.layers.3.mixer.conv1d_kernel"] == (
        "params", "l0_m", "bwd", "layer3", "mixer", "conv1d_kernel")
    want = jax.jit(jmod.apply)(v, rgb, ir)
    with torch.no_grad():
        got = pmod.eval()(*(torch.from_numpy(t).permute(0, 3, 1, 2)
                            for t in (rgb, ir)))
    for g, w in zip(got, want):
        _close(g.permute(0, 2, 3, 1), w)


@pytest.mark.parametrize("name", ["mamba_step", "residual_step",
                                  "mamba_stack_step"])
def test_step_functions_match_jax_and_the_parallel_forward(name):
    """Twelve tokens one at a time from fresh caches: each output against
    JAX's step function on the same params and cache, and against the
    port's parallel forward over the whole sequence (the conv is causal,
    so output t sees tokens 0..t only)."""
    module = {"mamba_step": "MambaBlock", "residual_step": "ResidualBlock",
              "mamba_stack_step": "Mamba"}[name]
    jmod, v, pmod = _pair(module)
    x = _tokens((2, 12, D), 3)
    cfg = _cfg()
    stack = name == "mamba_stack_step"
    jcache = jm.mamba_cache_init(cfg, 2)
    pcache = pm.mamba_cache_init(pm.MambaConfig(D, 2), 2)
    assert [tuple(t.shape) for c in pcache for t in c] == \
        [t.shape for c in jcache for t in c]
    if not stack:
        jcache, pcache = jcache[0], pcache[0]
    jstep = jax.jit(getattr(jm, name), static_argnums=1)
    pstep = getattr(pm, name)
    outs = []
    with torch.no_grad():
        for t in range(x.shape[1]):
            want, jcache = jstep(v["params"], cfg, x[:, t], jcache)
            got, pcache = pstep(pmod, torch.from_numpy(x[:, t]), pcache)
            _close(got, want)
            outs.append(got)
        _close(torch.stack(outs, 1), pmod(torch.from_numpy(x)).numpy())


# ------------------------------------------------------ the mamba grammar

@pytest.mark.parametrize("scale", "smlx")
def test_mamba_specs_resolve_as_the_jax_package(scale):
    name = f"yolov5{scale}_mamba"
    ps, js = get_model_spec(name), jax_get_spec(name)
    assert dataclasses.astuple(ps) == dataclasses.astuple(js)
    assert [l.name for l in ps.layers if l.name == "MambaFusion"] == \
        ["MambaFusion"] * 4
    # the meta-device forward that ``load_yolo_yaml`` runs
    assert pspec._infer_strides(dataclasses.replace(
        ps, strides=(1, 2, 4))).strides == (8, 16, 32)


# ----------------------------------------------------------- train step

def _traces(opt_state) -> dict:
    """optax's SGD momentum traces of every group, by the port's keys."""
    out = {}
    for st in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState)):
        if isinstance(st, optax.TraceState):
            for path, a in flax.traverse_util.flatten_dict(
                    st.trace).items():
                if not isinstance(a, optax.MaskedNode):
                    out[torch_key(path)[0]] = _to_torch(a, torch_key(path)[1])
    return out


def _one_level(layer_def, spec):
    return dataclasses.replace(spec, nc=2, layers=tuple(
        layer_def(l.f, l.n, "MambaFusion" if l.name == "GPT" else l.name,
                  l.args) for l in spec.layers))


def test_train_steps_of_a_mamba_model_match_jax():
    jspec = _one_level(JaxLayerDef, jax_dryrun_spec(nc=2))
    jmodel = JaxDetector(spec=jspec, aux_mode="reference")
    x = jnp.zeros((1, 64, 64, 3))
    variables = _seeded(jax.eval_shape(
        lambda k: jmodel.init({"params": k}, x, x, train=False),
        jax.random.PRNGKey(0)), 0)
    port = TwoStreamDetector(_one_level(LayerDef, dryrun_spec(nc=2)),
                             aux_mode="reference")
    from_jax_variables(port, jax.tree_util.tree_map(np.asarray, variables))
    sd0 = {k: v.clone() for k, v in port.state_dict().items()}
    sched = jsched.ScheduleConfig(epochs=2, steps_per_epoch=2, warmup_floor=1,
                                  lr0=0.001, warmup_bias_lr=0.001)
    tx, _ = jopt.build_optimizer(variables["params"], sched, 0.0005,
                                 total_batch_size=2, nbs=2)
    step = jax.jit(jax_make_train_step(
        jmodel, tx, jnp.asarray(_anchors(jspec)), JaxLossHyp()))
    opt, _ = popt.build_optimizer(port, psched.ScheduleConfig(
        **dataclasses.asdict(sched)), 0.0005, total_batch_size=2, nbs=2)
    pstate = init_state(port, opt)
    pstep = make_train_step(torch.from_numpy(_anchors(jspec)))
    jstate = jax_init_state(jmodel, tx, None, None, None,
                            variables=variables)
    for i in range(2):
        b = _batch(30 + i)
        jstate, jmet = step(jstate, {k: jnp.asarray(a) for k, a in b.items()},
                            jax.random.PRNGKey(0))
        pmet = pstep(pstate, {k: torch.from_numpy(a) for k, a in b.items()})
        for k in jmet:
            np.testing.assert_allclose(float(pmet[k]), float(jmet[k]),
                                       rtol=1e-4, atol=1e-6)
    moves = _check_moves({"params": jstate.params,
                          "batch_stats": jstate.batch_stats},
                         port.state_dict(), sd0, "state")
    # the momentum buffers hold the summed gradients (+ decay), which the
    # parameters' moves at these lr cannot resolve for the Mamba leaves
    want = _traces(jstate.opt_state)
    got = {k: opt.opt.state[p]["momentum_buffer"].numpy()
           for k, p in port.named_parameters()}
    assert set(got) == set(want)
    errs = {k: float(np.abs(got[k] - want[k]).max()) / max(
        float(np.abs(want[k]).max()), 1e-30) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])
    mixer = "model.8.bwd.layers.3.mixer."
    assert all(np.abs(got[mixer + k]).max() > 0 for k in (
        "A_log", "D", "conv1d_kernel", "conv1d_bias", "in_proj.weight",
        "x_proj.weight", "dt_proj.weight", "dt_proj.bias"))
    _check_moves({"params": jstate.ema["params"],
                  "batch_stats": jstate.ema["batch_stats"]},
                 pstate.ema.state_dict(), sd0, "ema")
