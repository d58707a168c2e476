"""PyTorch port, the exact OOD metrics' native route on the CPU: the
repository's C++ sort and sweep (``native/metrics.cc``), built by the port
into ``multishiftseg_torch/build/``, against the port's numpy path and the JAX
package's ``eval_ood_measure(use_native=True)``
(``multishiftseg_tpu/evals/ood_metrics.py:86-151``) above 2,000,000 labelled
pixels, with heavy ties; and the route each setting of ``use_native`` takes.
"""

import numpy as np
import pytest

from multishiftseg_tpu.evals import ood_metrics as jax_ood

from multishiftseg_torch.evals import ood_metrics


@pytest.fixture(scope="module")
def big():
    """2.3 M pixels: f32 scores on 41 levels (heavy ties), 10% OOD, 5% void."""
    g = np.random.RandomState(5)
    n = 2_300_000
    scores = (np.round(g.rand(n) * 40) / 40 + (g.rand(n) < 0.1) * 0.05).astype(np.float32)
    labels = (g.rand(n) < 0.1).astype(np.uint8)
    scores[labels == 1] += 0.1
    labels[g.rand(n) < 0.05] = 255
    assert ((labels == 0) | (labels == 1)).sum() >= ood_metrics.NATIVE_MIN_PIXELS
    return scores, labels


def test_native_route_matches_numpy_and_jax(big):
    """Above 2,000,000 labelled pixels the default route is the native one;
    its AUROC, AUPRC and FPR@95 equal the numpy path's and JAX's native
    route's within f32 score rounding (1e-6)."""
    assert ood_metrics.metrics_route(int((big[1] <= 1).sum())) == "native"
    got = ood_metrics.eval_ood_measure(*big)
    assert ood_metrics.eval_ood_measure(*big, use_native=True) == got
    numpy = ood_metrics.eval_ood_measure(*big, use_native=False)
    ref = jax_ood.eval_ood_measure(*big, use_native=True)
    np.testing.assert_allclose(got, numpy, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert 0.5 < got[0] < 1.0 and 0.0 < got[2] < 1.0


def test_routes_follow_use_native(big, monkeypatch):
    """``use_native=False`` keeps numpy at any size; None takes the native
    route from 2,000,000 labelled pixels on; True takes it at any size."""
    scores, labels = big[0][:5000], big[1][:5000]
    assert ood_metrics.metrics_route(10 ** 7, use_native=False) == "numpy"
    assert ood_metrics.metrics_route(ood_metrics.NATIVE_MIN_PIXELS - 1) == "numpy"
    assert ood_metrics.metrics_route(ood_metrics.NATIVE_MIN_PIXELS) == "native"
    assert ood_metrics.metrics_route(5000, use_native=True) == "native"
    calls = []
    native = ood_metrics.native_ood_metrics
    monkeypatch.setattr(ood_metrics, "native_ood_metrics",
                        lambda *a: calls.append(len(a[0])) or native(*a))
    small = ood_metrics.eval_ood_measure(scores, labels, use_native=True)
    numpy = ood_metrics.eval_ood_measure(scores, labels)
    assert ood_metrics.eval_ood_measure(scores, labels, use_native=False) == numpy
    assert calls == [int((labels <= 1).sum())]  # the native route ran once
    np.testing.assert_allclose(small, numpy, rtol=0, atol=1e-9)
    for use_native in (None, True, False):
        assert ood_metrics.eval_ood_measure(scores, np.zeros_like(labels),
                                            use_native=use_native) is None
