"""The port's spans (``utils/profiling.py``) on the CPU.

* With recording off, ``annotate`` returns one shared no-op, reads no
  clock and enters no ``record_function``: a smoke-size sampling chunk runs
  with the recorder's clock made to fail and leaves no span in a profile.
* With recording on, a smoke chunk through ``make_sharded_sampler`` (n DDIM
  steps, guidance 1, decode) records exactly one ``sample.chunk`` holding n
  ``sample.step``, each holding one ``estimator``, and one
  ``sample.decode``; a smoke train step records ``train.step`` holding
  ``train.forward`` (``train.encode`` and ``estimator`` in it),
  ``train.backward``, ``train.optimizer`` and ``train.ema``. Parents, rounds
  and each child's interval inside its parent's are checked.
* The spans' clock is ``torch.profiler``'s: an operator's event lies inside
  the span around it.
* Only the thread that switched recording on records; a recording inside
  another shares it.

The gradient all-reduce's counters at world 2 are in
``tests/test_torch_parallel.py``; the clock against the card's kernels and
``trace``'s kernels in ``tests/test_torch_profiling_cuda.py``.
"""

import threading

import pytest
import torch

from medfusion_tpu_torch.cli.presets import PRESETS, build_pipeline, build_train_pipeline
from medfusion_tpu_torch.parallel import make_mesh, make_sharded_sampler
from medfusion_tpu_torch.train import TrainState, make_diffusion_train_step
from medfusion_tpu_torch.utils import profiling
from tests import torch_parallel_worker as W

P = PRESETS["smoke"]
STEPS = 3
SPANS = {"sample.chunk", "sample.step", "estimator", "sample.decode"}


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _chunk():
    """One smoke chunk of 2 rows through the sharded sampler at world 1."""
    pipe = build_pipeline(P, device="cpu")
    with W.one_rank_group():
        fn = make_sharded_sampler(pipe, make_mesh(n_model=1, device="cpu"), P.latent_shape,
                                  steps=STEPS, guidance_scale=1.0, decode=True)
        return fn(torch.Generator().manual_seed(0), 2, torch.tensor([0, 1]))


def _children(spans, i):
    return [s.name for s in spans if s.parent == i]


def _check_nesting(spans):
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            up = spans[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns, (up, s)
            assert s.round == up.round


def test_annotate_is_a_shared_no_op_with_recording_off(monkeypatch):
    assert profiling.annotate("a") is profiling.annotate("b", rows=3) is profiling.NO_SPAN
    with profiling.annotate("a") as span:
        span.count(bytes=1)

    class NoClock:
        def time_ns(self):
            raise AssertionError("the clock read with recording off")

    monkeypatch.setattr(profiling, "time", NoClock())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = _chunk()
    assert out.shape == (2, P.image_size, P.image_size, P.in_channels)
    assert not {e.name for e in prof.events()} & SPANS  # no record_function entered


def test_a_smoke_chunk_records_the_samplers_tree():
    with profiling.recording() as rec:
        _chunk()
    spans = rec.spans
    names = [s.name for s in spans]
    assert names.count("sample.chunk") == 1 and names.count("sample.decode") == 1
    assert names.count("sample.step") == names.count("estimator") == STEPS
    (root,) = [i for i, s in enumerate(spans) if s.parent is None]
    assert spans[root].name == "sample.chunk" and spans[root].counters == {"rows": 2}
    assert _children(spans, root) == ["sample.step"] * STEPS + ["sample.decode"]
    for i, s in enumerate(spans):
        if s.name == "sample.step":
            assert _children(spans, i) == ["estimator"]
    assert {s.round for s in spans} == {0} and rec.rounds == 1
    _check_nesting(spans)


def test_a_smoke_train_step_records_its_phases():
    pipe = build_train_pipeline(P, device="cpu")
    state = TrainState(pipe.noise_estimator, use_ema=True)
    step = make_diffusion_train_step(pipe)
    gen = torch.Generator().manual_seed(0)
    batch = {"source": torch.rand((2, P.image_size, P.image_size, P.in_channels), generator=gen),
             "target": torch.tensor([0, 1])}
    draws = pipe.train_draws(2, P.latent_shape, generator=gen)
    with profiling.recording() as rec:
        step(state, batch, draws)
        step(state, batch, draws)
    spans = rec.spans
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["train.step"] * 2
    assert [spans[i].round for i in roots] == [0, 1] and rec.rounds == 2
    for i in roots:
        assert _children(spans, i) == ["train.forward", "train.backward", "train.optimizer",
                                       "train.ema"]
        forward = next(j for j, s in enumerate(spans) if s.parent == i)
        assert _children(spans, forward) == ["train.encode", "estimator"]
    assert len(spans) == 2 * 7
    _check_nesting(spans)


def test_spans_are_on_the_profilers_clock():
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.recording() as rec:
            with profiling.annotate("clock"):
                torch.ones(64, 64) @ torch.ones(64, 64)
    (span,) = rec.spans
    events = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU and e.name() == "aten::mm"]
    assert events
    assert all(span.start_ns <= e.start_ns() <= e.end_ns() <= span.end_ns for e in events)
    # and the span is in the profile, under its name
    assert any(e.name == "clock" for e in prof.events())


def test_only_the_recording_thread_records_and_nested_recordings_share():
    seen = []
    with profiling.recording() as rec:
        with profiling.recording() as inner:
            assert inner is rec
            t = threading.Thread(target=lambda: seen.append(profiling.annotate("other")))
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()
            with profiling.annotate("mine", rows=4) as span:
                span.count(rows=1, bytes=8)
    assert seen == [profiling.NO_SPAN]
    assert [(s.name, s.counters) for s in rec.spans] == [("mine", {"rows": 5, "bytes": 8})]
    assert profiling.annotate("after") is profiling.NO_SPAN
