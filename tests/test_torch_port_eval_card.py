"""Card tests of the port's evaluation (no JAX here: the card's machine has
none). Run on the card with

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_port_eval_card.py

The ``gpu`` tests skip where ``torch.cuda.is_available()`` is False.
"""

import numpy as np
import pytest
import torch

from viscy_tpu_torch.evaluation import umap_native as tumap


@pytest.mark.gpu
def test_two_card_layouts_are_identical():
    """The layout adds each row's terms in index order (``index_put_`` with
    ``accumulate=True``, sorted, no atomics), so two card calls from the
    same start and draws agree bit for bit, and torch's process-wide
    deterministic mode stays as it was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 8)) + np.linspace(0, 6, 300)[:, None] * rng.normal(size=8)
    p = tumap.NativeUMAP(n_epochs=200, device="cuda").prepare(X)
    kw = dict(n_epochs=200, a=p["a"], b=p["b"], lr=1.0, negative_sample_rate=5, random_state=3, device="cuda")
    one = tumap.optimize_layout(p["init"], p["head"], p["tail"], p["weights"], **kw)
    two = tumap.optimize_layout(p["init"], p["head"], p["tail"], p["weights"], **kw)
    np.testing.assert_array_equal(one, two)
    assert not torch.are_deterministic_algorithms_enabled()
