"""The trainer resumed between two optimizer steps, against the JAX
package on the CPU in f32: ``yolov5s_add`` at 64 px, batch 2, accumulate 2
over 3 steps an epoch, so the first epoch's checkpoint holds a partial
gradient sum that the resumed run must carry on, as the JAX package's
``MultiSteps`` state does (``tests/test_torch_port_train.py`` holds the
helpers, and the same run at accumulate 1).  JAX compiles its train step
for accumulate 2 once."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from mmidet_tpu.losses.detection import LossHyp as JaxLossHyp
from mmidet_tpu.train import optimizer as jopt
from mmidet_tpu.train.step import make_train_step as jax_make_train_step
from mmidet_tpu_torch.data.synthetic import make_synthetic_pair_dataset
from test_torch_port_train import (SCHED, _anchors, _threads,  # noqa: F401
                                   add_pair, trainer_against_jax)


@pytest.fixture(scope="module")
def data_yaml(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume_synth")
    return make_synthetic_pair_dataset(str(root), n=6, img=64)


def test_trainer_resumes_between_optimizer_steps_against_jax(
        data_yaml, tmp_path, add_pair, monkeypatch):
    jmodel, variables, _ = add_pair
    tx, _ = jopt.build_optimizer(
        variables["params"], dataclasses.replace(SCHED, steps_per_epoch=3),
        0.0005, total_batch_size=2, nbs=4)
    step = jax.jit(jax_make_train_step(
        jmodel, tx, jnp.asarray(_anchors(jmodel.spec)), JaxLossHyp()))
    trainer_against_jax(data_yaml, 6, 4, add_pair, tx, step, tmp_path,
                        monkeypatch)
