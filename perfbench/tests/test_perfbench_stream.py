"""The benchmark's frozen token stream equals the program's."""
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.traffic.markov import MarkovStream  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402


@pytest.mark.parametrize("seed", [0, 7, 3_000_000_019])
def test_stream_equals_the_programs(seed):
    ours = MarkovStream(512, 48, 4, seed)
    theirs = SyntheticLMDataset(512, 48, 4, seed=seed)
    for step in (0, 1, 17):
        a, b = ours.batch(step), theirs.batch(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_stream_depends_on_seed_and_step():
    s = MarkovStream(151936, 256, 4, 5)
    assert not np.array_equal(s.batch(0)["tokens"], s.batch(1)["tokens"])
    assert not np.array_equal(s.batch(0)["tokens"],
                              MarkovStream(151936, 256, 4, 6)
                              .batch(0)["tokens"])
    b = s.batch(3)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
