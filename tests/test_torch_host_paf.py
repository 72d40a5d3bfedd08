"""The port's copy of the PAF writer against the JAX package's: the
float32 position scale and positions, the at/aq/sm means, the tag string
and whole mapped and unmapped lines, on seeded inputs."""

import numpy as np
import pytest

from rawalign_tpu.io import paf as jpaf
from rawalign_tpu_torch.io import paf as tpaf


@pytest.mark.parametrize("seed", range(4))
def test_scales_and_means_equal_the_jax_writer(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        args = (int(rng.integers(1, 30)), int(rng.integers(1000, 8000)),
                int(rng.integers(0, 5000)), float(rng.choice([4000, 5000])),
                float(rng.choice([400, 450])))
        s, js = tpaf.position_scale_f32(*args), jpaf.position_scale_f32(*args)
        assert s.tobytes() == js.tobytes()
        pos = int(rng.integers(0, 1 << 20))
        assert tpaf.scale_pos(s, pos) == jpaf.scale_pos(js, pos)
    for n in (0, 1, 2, 50):
        # columns (target, query); large deltas cross 2**24 (the f32 fold)
        anchors = np.sort(rng.integers(0, 1 << 26, (n, 2)), axis=0)[::-1]
        assert tpaf.anchor_gap_means_f32(anchors) == jpaf.anchor_gap_means_f32(anchors)
        scores = rng.uniform(0, 500, n).astype(np.float32).tolist()
        assert tpaf.mean_score_f32(scores) == jpaf.mean_score_f32(scores)


def _tags(mod, rng, mapped):
    kw = dict(mapping_time_ms=float(rng.uniform(0, 100)),
              n_chunks=int(rng.integers(1, 5)), qlen=int(rng.integers(1, 9000)))
    if mapped:
        kw.update(n_anchors0=int(rng.integers(2, 90)), n_chains=3,
                  s1=float(rng.uniform(10, 300)), s2=float(rng.uniform(0, 10)),
                  sm=float(rng.uniform(0, 100)), at=1.25, aq=-0.5,
                  mapped_with_chains=True, alns=float(rng.uniform(0, 99)),
                  aln="3=1X2D", anchors="10,12;30,31")
    return mod.build_tags(**kw)


@pytest.mark.parametrize("mapped", [True, False])
@pytest.mark.parametrize("rev", [0, 1])
def test_lines_equal_the_jax_writer(mapped, rev):
    rng = np.random.default_rng(7 + rev)
    tags = _tags(tpaf, np.random.default_rng(3), mapped)
    assert tags == _tags(jpaf, np.random.default_rng(3), mapped)
    fields = dict(read_name="read-1", read_length=int(rng.integers(10, 900)),
                  mapped=mapped, read_start_position=0, read_end_position=0,
                  ref_name="chr1", ref_len=12000, fragment_start_position=4100,
                  fragment_length=650, rev=rev, mapq=int(rng.integers(0, 60)),
                  tags=tags)
    line = tpaf.paf_line(tpaf.MappingResult(**fields))
    assert line == jpaf.paf_line(jpaf.MappingResult(**fields))
    assert line.count("\t") >= 12
