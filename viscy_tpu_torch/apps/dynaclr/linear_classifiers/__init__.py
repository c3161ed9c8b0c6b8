"""Orchestrated linear-classifier evaluation of DynaCLR embeddings
(counterpart of ``viscy_tpu/apps/dynaclr/linear_classifiers/``): the
rotating leave-one-dataset-out cross-validation with its dataset-impact
analysis (:mod:`.cross_validation`), the multi-marker orchestrated pipeline
with atomic publication (:mod:`.orchestrated`) and the discovery utilities
(:mod:`.utils`). JAX's PDF report (``report.py``) needs matplotlib and is
refused by name (ROADMAP.md Queue 1 item 9).
"""

from viscy_tpu_torch.apps.dynaclr.linear_classifiers.cross_validation import cross_validate  # noqa: F401
from viscy_tpu_torch.apps.dynaclr.linear_classifiers.orchestrated import run_linear_classifiers  # noqa: F401
