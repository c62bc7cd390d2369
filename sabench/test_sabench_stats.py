"""The benchmark's arithmetic."""
import math

from sabench import stats


def union(spans, *bounds):
    return sum(e - s for s, e in stats.merged_intervals(spans, *bounds))


def test_interval_union_counts_overlaps_once_and_clips():
    spans = [(0, 4), (2, 6), (8, 9), (8.5, 10), (20, 30)]
    assert union(spans) == 6 + 2 + 10
    assert union(spans, 1, 21) == 5 + 2 + 1
    assert stats.merged_intervals(spans, 1, 21) == [(1, 6), (8, 10),
                                                    (20, 21)]
    assert union([]) == 0


def test_idle_gaps_are_the_uncovered_rest():
    merged = stats.merged_intervals([(2, 3), (5, 7)], 0, 10)
    assert stats.idle_gaps(merged, 0, 10) == [(0, 2), (3, 5), (7, 10)]
    assert stats.idle_gaps([], 0, 1) == [(0, 1)]


def test_rate_is_all_whole_builds_over_all_the_time():
    builds = [(100, 11.0), (100, 12.5), (100, 14.0)]
    assert stats.rate_over_builds(builds, 10.0) == 300 / 4.0
    assert stats.rate_over_builds([], 10.0) is None


def test_quartile_spread_uses_pythons_quartiles():
    values = [10, 11, 12, 13, 14, 15]
    q1, q2, q3 = 10.75, 12.5, 14.25
    assert math.isclose(stats.quartile_spread(values), (q3 - q1) / q2)
