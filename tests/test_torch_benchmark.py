"""``gemm_hls_tpu_torch.utils.benchmark`` on the CPU, with ``torch.cuda``'s
events and synchronisation stubbed: the argument form of ``time_fn`` (the
reference's ``time_fn(fn, args_sets, ...)``: a sequence of argument tuples,
the first one timed), its refusal without a card, and
``interleaved_medians``.  No time measured here is a device time."""

import pytest
import torch

from gemm_hls_tpu_torch.utils import benchmark


class _Event:
    """A CUDA event stand-in: each window reads ``ms`` milliseconds."""
    ms = 2.0

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return self.ms


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)


def test_time_fn_calls_fn_with_the_first_argument_set(fake_cuda):
    a, b = torch.ones(2), torch.zeros(3)
    calls = []

    def fn(*args):
        calls.append(args)
        return args[0] + 1

    secs = benchmark.time_fn(fn, [(a, b), (b, a)], iters=4, warmup=2, repeats=3)
    # warmup + iters x repeats calls, each fn(a, b): never fn((a, b)) and
    # never the second set.
    assert len(calls) == 2 + 4 * 3
    assert all(len(c) == 2 and c[0] is a and c[1] is b for c in calls)
    assert secs == pytest.approx(_Event.ms / 1e3 / 4)


def test_time_fn_no_argument_form(fake_cuda):
    calls = []
    benchmark.time_fn(lambda: calls.append(1) or torch.ones(1), [()], iters=2, warmup=0,
                      repeats=1)
    assert calls == [1, 1]


def test_time_fn_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark.time_fn(lambda: torch.ones(1), [()])


def test_time_fn_requires_tensor_outputs(fake_cuda):
    with pytest.raises(TypeError, match="unexpected output type"):
        benchmark.time_fn(lambda x: float(x.sum()), [(torch.ones(2),)], iters=1, warmup=0)


def test_interleaved_medians(fake_cuda, monkeypatch):
    seen = []

    def f(x, y):
        seen.append("f")
        return x @ y

    def g(x, y):
        seen.append("g")
        return x + y

    x = torch.ones(2, 2)
    # 2 ms a call (iters 1): 1e9 flops give 500 GFLOP/s.
    out = benchmark.interleaved_medians([f, g], (x, x), 1e9, None, rounds=2, iters=1)
    assert out == [pytest.approx(500.0), pytest.approx(500.0)]
    # Interleaved: each round times f, then g (warmup 2 + 3 windows each).
    assert seen == ["f"] * 5 + ["g"] * 5 + ["f"] * 5 + ["g"] * 5
    with pytest.raises(RuntimeError, match="no physically possible reading"):
        benchmark.interleaved_medians([f], (x, x), 1e9, 100.0, rounds=1, iters=1)
