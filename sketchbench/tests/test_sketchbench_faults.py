"""A run with its timed path broken underneath comes out not correct.

Each test runs the harness in this process on the CPU (the rehearsal,
which skips the look for a card) with the program patched: a step that
returns its state unchanged, half of each batch left out, an answer
altered where it is produced.  The cells run on one card with no exchange
between cards, so that fault has no place to be planted."""

import json

import pytest

from sketchbench import cell

INGEST = ("ddlog.ingest_ragged", "ddcubic.ingest_dense")
DASH = ("ddlog.dash_wide", "ddcubic.dash_narrow")


def run(capsys, workload, seed=17):
    rc = cell.main(["--workload", workload, "--seed", str(seed), "--seconds", "0.3",
                    "--cpu-rehearsal", "--streams", "256"])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", INGEST + DASH)
def test_sound_program_is_correct(capsys, workload):
    assert run(capsys, workload)["correct"] is True


@pytest.mark.parametrize("workload", INGEST + DASH)
def test_step_returning_its_state_unchanged(capsys, monkeypatch, workload):
    from sketches_tpu_torch import kernels

    monkeypatch.setattr(kernels, "add", lambda spec, state, *a, **k: state)
    res = run(capsys, workload)
    assert res["correct"] is False and res["check"]["rows_off"]["value"] > 0


@pytest.mark.parametrize("workload", INGEST + DASH)
def test_half_of_each_batch_left_out(capsys, monkeypatch, workload):
    from sketches_tpu_torch import kernels

    real = kernels.add

    def half(spec, state, values, weights=None, **k):
        w = values.shape[1] // 2
        return real(spec, state, values[:, :w].contiguous(),
                    None if weights is None else weights[:, :w].contiguous(), **k)

    monkeypatch.setattr(kernels, "add", half)
    res = run(capsys, workload)
    assert res["correct"] is False and res["check"]["rows_off"]["value"] > 0


@pytest.mark.parametrize("workload", DASH)
def test_answer_altered_where_produced(capsys, monkeypatch, workload):
    from sketches_tpu_torch import BatchedDDSketch

    real = BatchedDDSketch.get_quantile_values_resolved

    def altered(self, qs, disabled_tiers=()):
        tier, out = real(self, qs, disabled_tiers)
        out = out.clone()
        out[5, 1] = out[5, 1] * (self.spec.gamma ** 2)
        return tier, out

    monkeypatch.setattr(BatchedDDSketch, "get_quantile_values_resolved", altered)
    res = run(capsys, workload)
    assert res["correct"] is False
    assert res["check"]["answers_off"]["value"] > 0 and res["check"]["rows_off"]["value"] == 0


def test_plain_path_answers_are_judged_too(capsys, monkeypatch):
    """The query's value decode shifted by one bucket everywhere."""
    from sketches_tpu_torch import BatchedDDSketch

    real = BatchedDDSketch.get_quantile_values_resolved
    monkeypatch.setattr(BatchedDDSketch, "get_quantile_values_resolved",
                        lambda self, qs, d=(): (lambda t, o: (t, o / self.spec.gamma))(
                            *real(self, qs, d)))
    res = run(capsys, "ddcubic.dash_narrow")
    assert res["correct"] is False
    # All but the answers whose bucket a float32 key may round either way.
    assert res["check"]["answers_off"]["value"] >= 0.99 * res["attempted"] * 256 * 4
