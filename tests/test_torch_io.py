"""The port's host-side copies (datasets, measurements, g2o IO) give the
same arrays as the JAX package's."""

import numpy as np
import pytest

from dpgo_tpu import datasets as jd
from dpgo_tpu.io import g2o as jg
from dpgo_tpu_torch import datasets as td
from dpgo_tpu_torch import measurements as tm
from dpgo_tpu_torch.io import g2o as tg


def _same_edges(a, b):
    for k in ("r1", "r2", "p1", "p2", "R", "t", "kappa", "tau", "weight",
              "fixed_weight"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


@pytest.mark.parametrize("make,n", [("synthesize_city2d", 300),
                                    ("synthesize_grid3d", 64)])
def test_synthesizers_match(make, n):
    je, jn, jT = getattr(jd, make)(n, seed=4)
    te, tn, tT = getattr(td, make)(n, seed=4)
    assert jn == tn
    _same_edges(je, te)
    np.testing.assert_array_equal(jT, tT)
    jo, jp = jd.plant_outliers(je.to_measurements(), n, seed=1)
    to, tp = td.plant_outliers(te.to_measurements(), n, seed=1)
    assert jp == tp
    _same_edges(tm.EdgeArrays.from_measurements(to),
                tm.EdgeArrays.from_measurements(jo))


def test_g2o_round_trip_matches(tmp_path):
    edges, n, _ = td.synthesize_grid3d(27, seed=0)
    path = str(tmp_path / "grid27.g2o")
    td.write_g2o(edges, path)
    te, tn = tg.read_g2o_arrays(path)
    je, jn = jg.read_g2o_arrays(path)
    assert tn == jn == n
    _same_edges(te, je)
    _same_edges(tg._read_g2o_arrays_py(path)[0], jg._read_g2o_arrays_py(path)[0])
    np.testing.assert_allclose(te.R, edges.R, atol=1e-9)
    np.testing.assert_allclose(te.kappa, edges.kappa, rtol=1e-9)
    meas, mn = tg.read_g2o_file(path)
    assert mn == n and len(meas) == edges.m
    assert tm.num_poses_and_dim(meas) == (3, n)
