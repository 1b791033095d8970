"""The port's numpy data pipeline against the reference's: the synthetic
traffic, the feature windows, the per-client batches and the error
metrics are equal exactly (the same numpy code on the same seeds)."""
import numpy as np
import pytest
from test_torch_reference import reference  # noqa: F401  (fixture)

from repro_torch.configs import MLP_H1, MLP_H24
from repro_torch.data import (DATASETS, build_windows, client_batches,
                              make_dataset, rmse_mae)


def _assert_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_make_dataset_matches_reference(reference, name):
    _assert_dicts_equal(make_dataset(name, 3, seed=1),
                        reference.data.make_dataset(name, 3, seed=1))


@pytest.mark.parametrize("cfg", [MLP_H1, MLP_H24], ids=["h1", "h24"])
def test_windows_batches_and_metrics_match_reference(reference, cfg):
    r = reference
    rcfg = r.configs.MLP_H1 if cfg.horizon == 1 else r.configs.MLP_H24
    data = make_dataset("milano", 3, seed=0)
    train, test, scalers = build_windows(data, cfg)
    rtrain, rtest, rscalers = r.data.build_windows(
        r.data.make_dataset("milano", 3, seed=0), rcfg)
    _assert_dicts_equal(train, rtrain)
    _assert_dicts_equal(test, rtest)
    for sc, rsc in zip(scalers, rscalers):
        np.testing.assert_array_equal(sc.lo, rsc.lo)
        np.testing.assert_array_equal(sc.hi, rsc.hi)
    x, y = client_batches(np.random.RandomState(5), train, 32)
    rx, ry = r.windowing.client_batches(np.random.RandomState(5), rtrain, 32)
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_array_equal(y, ry)
    assert x.dtype == np.float32 and x.shape == (3, 32, cfg.d_x)
    pred = test["y"][0] * 1.1
    assert rmse_mae(scalers[0].inverse_y(pred), test["y_raw"][0]) \
        == r.windowing.rmse_mae(rscalers[0].inverse_y(pred),
                                rtest["y_raw"][0])
