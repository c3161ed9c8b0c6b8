"""DTW pseudotime (counterpart of ``viscy_tpu/apps/dynaclr/pseudotime/``).

Modules: :mod:`.dtw_core` (the DP in host kernel H2, paths, DBA),
:mod:`.alignment` (lineage-aware ``t_perturb``), :mod:`.dtw_alignment`
(template building and track alignment), :mod:`.signals` (annotation,
prediction and embedding-distance signals), :mod:`.metrics` (population
curves, onset and peak timing, statistical tests), :mod:`.io` (template
zarr stores), :mod:`.evaluation` (pseudotime against annotations), and the
first API, ``dtw_align`` and ``compute_pseudotime``. Tables are
:class:`~viscy_tpu_torch.evaluation.anndata_lite.Frame` tables, not pandas.
"""

from viscy_tpu_torch.apps.dynaclr.pseudotime._legacy import compute_pseudotime, dtw_align  # noqa: F401
from viscy_tpu_torch.apps.dynaclr.pseudotime.dtw_alignment import (  # noqa: F401
    DEFAULT_POSITIVE_CLASSES,
    AlignmentResult,
    TemplateResult,
    alignment_results_to_dataframe,
    build_template,
    classify_response_groups,
    dtw_align_tracks,
    extract_dtw_pseudotime,
    resample_template_to_frame_interval,
)
from viscy_tpu_torch.apps.dynaclr.pseudotime.dtw_core import (  # noqa: F401
    dba,
    dtw_align_pair,
    dtw_distance,
    subsequence_align,
)
from viscy_tpu_torch.apps.dynaclr.pseudotime.io import (  # noqa: F401
    compute_tau_event_band,
    date_prefix_from_dataset_id,
    find_embedding_zarr,
    get_dynaclr_versions,
    load_template_flavor,
    read_tau_event_band,
    read_template_attrs,
    read_time_calibration,
    save_template_zarr,
)
