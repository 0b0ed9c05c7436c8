"""The comparison that decides `correct`, on the CPU at a small size: the
reference agrees with the port's fit and transform, the control (the
reference in TF32 arithmetic in the program's place) does not, and a run
whose timed path is broken underneath comes out not correct."""

import numpy as np
import pytest
import torch

from conftest import run_on_cpu, tiny_cell
from portbench import compare, load, program
from portbench.plugins import plugin

FIT_CELLS = ["lr_sparse.fit_sweep", "lr_dense_conf.fit_sweep"]
SCORE_CELLS = ["lr_sparse.score_10m", "lr_dense_conf.score_10m"]


def _answers(cell, seed=11, seconds=0.3):
    device = torch.device("cpu")
    with program.device_scope(device):
        tensors = plugin("data", cell.config["data"]["kind"]).make(cell.config["data"], seed,
                                                                   device)
        work = load.Workload(cell.mix, cell.config, tensors, seed, device)
        work.warm()
        work.run(seconds)
        return work.answers(), tensors


@pytest.mark.parametrize("name", FIT_CELLS + SCORE_CELLS)
def test_reference_matches_the_port_and_the_control_does_not(name):
    rows = 200_000 if name in SCORE_CELLS else 20_000
    cell = tiny_cell(name, rows=rows, features=50_000, batch=10_000)
    answers, tensors = _answers(cell)
    reference = compare.Reference(cell.config, tensors)
    got = compare.measure(cell.limits, answers, reference)
    assert compare.within(got, cell.limits), got
    control = compare.control_answers(answers, compare.Reference(cell.config, tensors, "tf32"))
    ctl = compare.measure(cell.limits, control, reference)
    assert not compare.within(ctl, cell.limits), ctl


def test_reference_fit_is_the_sgd_of_the_description():
    # two rows, d = 1, one batch, lr 1: the first epoch's gradient, then one update after the loop
    from portbench.reference import linear_sgd as ref

    X = torch.tensor([[1.0], [2.0]])
    y = torch.tensor([1.0, 0.0])
    params = {"maxIter": 1, "globalBatchSize": 2, "learningRate": 1.0, "reg": 0.0,
              "elasticNet": 0.0, "tol": 0.0}
    coeff = ref.sgd_fit(ref.DenseRows(X, y), params, ref.Arith("float64"))
    grad = 1.0 * (-1.0 / 2.0) + 2.0 * (1.0 / 2.0)  # multipliers at dot 0: -0.5 and +0.5
    assert np.allclose(coeff.numpy(), [-grad / 2.0])


def test_round_tf32_keeps_ten_mantissa_bits():
    from portbench.reference.linear_sgd import round_tf32

    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, -1.0 - 2.0 ** -12, 1.0 + 2.0 ** -10])
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2.0 ** -9, -1.0, 1.0 + 2.0 ** -10]


# -- faults planted under the timed path --------------------------------------

def _unchanged_step(monkeypatch):
    from flink_ml_tpu_torch.ops import optimizer

    monkeypatch.setattr(optimizer, "_epoch_step",
                        lambda Xk, yk, wk, carry, loss_func, hyper:
                        (carry, torch.ones((), dtype=torch.float32)))


def _half_batch(monkeypatch):
    from flink_ml_tpu_torch.ops import optimizer

    step = optimizer._epoch_step

    def half(Xk, yk, wk, carry, loss_func, hyper):
        wk = wk.clone()
        wk[1::2] = 0.0  # the odd rows left out; the mean is taken over the rest
        return step(Xk, yk, wk, carry, loss_func, hyper)

    monkeypatch.setattr(optimizer, "_epoch_step", half)


def _altered_coefficient(monkeypatch):
    from flink_ml_tpu_torch.models import _linear

    read = _linear.read_train_result

    def altered(result):
        flag, coeff, criteria, epochs = read(result)
        coeff = coeff.copy()
        coeff[0] += 1.0
        return flag, coeff, criteria, epochs

    monkeypatch.setattr(_linear, "read_train_result", altered)


def _half_rows_scored(monkeypatch):
    from flink_ml_tpu_torch.models.classification import logisticregression as lr

    predict = lr._predict_from_dot

    def half(dot):
        dot = dot.clone()
        dot[dot.shape[0] // 2:] = 0.0  # the second half left unscored
        return predict(dot)

    monkeypatch.setattr(lr, "_predict_from_dot", half)


def _altered_label(monkeypatch):
    from flink_ml_tpu_torch.models.classification import logisticregression as lr

    predict = lr._predict_from_dot

    def altered(dot):
        pred, raw = predict(dot)
        pred = pred.clone()
        i = int(torch.argmax(dot.abs()))
        pred[i] = 1.0 - pred[i]
        return pred, raw

    monkeypatch.setattr(lr, "_predict_from_dot", altered)


@pytest.mark.parametrize("fault", [_unchanged_step, _half_batch, _altered_coefficient])
@pytest.mark.parametrize("name", FIT_CELLS)
def test_broken_fit_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    assert run_on_cpu(cell)["correct"]
    fault(monkeypatch)
    assert not run_on_cpu(cell)["correct"]


@pytest.mark.parametrize("fault", [_half_rows_scored, _altered_label])
@pytest.mark.parametrize("name", SCORE_CELLS)
def test_broken_transform_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    assert run_on_cpu(cell)["correct"]
    fault(monkeypatch)
    assert not run_on_cpu(cell)["correct"]
