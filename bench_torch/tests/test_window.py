"""The window's arithmetic: a planted stall in a synthetic window lowers
frames_per_s and raises call_p90_ms."""

from bench_torch.core.window import Call, frames_per_s, percentile_ms


def _window(walls, frames=1024):
    calls, t = [], 0.0
    for w in walls:
        calls.append(Call(t, t + w, frames))
        t += w
    return calls


def test_rate_and_percentile():
    calls = _window([0.2] * 150)
    assert abs(frames_per_s(calls) - 1024 / 0.2) < 1e-6
    assert abs(percentile_ms(calls, 90) - 200.0) < 1e-9


def test_planted_stall_shows():
    steady = [0.2 + 0.001 * (i % 7) for i in range(150)]
    stalled = list(steady)
    for i in range(10, 150, 8):  # one call in eight stalls by 80 ms
        stalled[i] += 0.08
    a, b = _window(steady), _window(stalled)
    assert frames_per_s(b) < frames_per_s(a) * 0.97
    assert percentile_ms(b, 90) > percentile_ms(a, 90) + 50.0


def test_rate_counts_the_last_call_past_the_close():
    calls = [Call(0.0, 0.5, 10), Call(0.5, 1.5, 10)]
    assert frames_per_s(calls) == 20 / 1.5

