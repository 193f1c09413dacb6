"""The mesh rules of the port's parallelism (``parallel/mesh.py``: the
tensor-parallel sharding rule, the attention's shards, the default device
list, ``setup_mesh``) against the JAX package's on the CPU; apart from
``test_torch_port_mesh.py``'s runs over ranks."""

import flax
import jax
import numpy as np
import pytest
import torch

from mmidet_tpu.models.detector import TwoStreamDetector as JaxDetector
from mmidet_tpu.models.zoo import get_model_spec as jax_get_spec
from mmidet_tpu.parallel import mesh as jmesh
from mmidet_tpu.train import trainer as jtrainer
from mmidet_tpu_torch.bridge import repeated_rows, torch_key
from mmidet_tpu_torch.models.detector import TwoStreamDetector
from mmidet_tpu_torch.models.zoo import get_model_spec
from mmidet_tpu_torch.parallel import mesh as pmesh
from mmidet_tpu_torch.parallel.mesh import tp_modules
from mmidet_tpu_torch.train import trainer

from test_torch_port_train import _jax_shapes, _threads  # noqa: F401

FLAGSHIP = "yolov5l_fuse3_fourier"
_MODELS = {}


@pytest.mark.parametrize("model,n_model,tp_min_out", [
    ("yolov5s_add", 2, 64), (FLAGSHIP, 2, 256), (FLAGSHIP, 4, 256)])
def test_sharding_rule_picks_jax_leaves(model, n_model, tp_min_out):
    """``tp_modules`` names exactly the leaves that JAX's
    ``param_shardings`` puts on 'model', through the bridge (the flagship's
    GPT1_fourier blocks included)."""
    if model not in _MODELS:  # JAX's shapes (traced only), the port's
        with torch.device("meta"):   # layers without their weights' values
            port = TwoStreamDetector(get_model_spec(model, nc=2),
                                     aux_mode="reference")
        _MODELS[model] = (_jax_shapes(JaxDetector(
            spec=jax_get_spec(model, nc=2), aux_mode="reference")), port)
    shapes, port = _MODELS[model]
    mesh = jmesh.make_mesh(8 // n_model, n_model, jax.devices()[:8])
    specs = jmesh.param_shardings(shapes["params"], mesh, tp_min_out)
    rep = repeated_rows(shapes)
    want = {torch_key(path, rep)[0] for path, s in
            flax.traverse_util.flatten_dict(specs).items()
            if any(a is not None for a in s.spec)}
    got = {f"{n}.weight" for n in tp_modules(port, n_model, tp_min_out)}
    assert got == want and want


def test_attention_shards_are_jax_head_dim_slices():
    """A query/key/value kernel (c, heads, head_dim) shards head_dim in
    JAX: each rank's rows of the torch weight are those of its slice
    (``bridge.to_torch_layout``), and the gathered shards go back in
    order."""
    from mmidet_tpu_torch.bridge import to_torch_layout
    from mmidet_tpu_torch.parallel.mesh import _rows
    c, heads, n = 16, 4, 2
    k = np.arange(c * c, dtype=np.float32).reshape(c, heads, c // heads)
    w = torch.from_numpy(to_torch_layout(k, "mha_in"))
    lin = torch.nn.Linear(c, c)
    parts, perm = [], None
    for m in range(n):
        rows, perm = _rows(lin, n, m, heads)
        hd = c // heads // n
        want = to_torch_layout(np.ascontiguousarray(
            k[:, :, m * hd:(m + 1) * hd]), "mha_in")
        np.testing.assert_array_equal(w[rows].numpy(), want)
        parts.append(w[rows])
    assert torch.equal(torch.cat(parts)[perm], w)


@pytest.mark.parametrize("device,want", [
    ("cuda", ["cuda:0", "cuda:1"]), ("cuda:1", ["cuda:1"]),
    ("cpu", ["cpu"])])
def test_default_devices_take_every_card_only_for_a_bare_cuda(
        monkeypatch, device, want):
    """The default of ``train``, ``evaluate`` and the serve CLI: every
    visible card (``jax.devices()``) for a bare ``"cuda"``; a device with
    an index, or the CPU, is that device alone (here with two cards
    faked)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pmesh.default_devices(device) == [torch.device(d) for d in want]


@pytest.mark.parametrize("case", [
    dict(batch_size=8, n_model=2), dict(batch_size=3),
    dict(batch_size=8, mesh="off"), dict(batch_size=8, devices=1),
    dict(batch_size=8, n_model=16), dict(batch_size=8, n_model=2,
                                         devices=1)])
def test_setup_mesh_follows_jax(case):
    """Shapes, the data axis' clamp and the errors, as JAX's
    ``setup_mesh`` on the cases of ``tests/test_trainer_mesh.py``."""
    case = dict(case)
    n = case.pop("devices", 8)
    jdevs, pdevs = jax.devices()[:n], ["cpu"] * n

    def outcome(fn, cfg, devs):
        try:
            return fn(cfg, devs)
        except ValueError as e:
            return type(e)
    want = outcome(jtrainer.setup_mesh, jtrainer.TrainConfig(**case), jdevs)
    got = outcome(trainer.setup_mesh, trainer.TrainConfig(**case), pdevs)
    if want is ValueError:
        assert got is ValueError
    elif want[0] is None:
        assert got is None
    else:
        assert got == (want[0].shape["data"], want[0].shape["model"])
