"""FOV metadata schema (counterpart of ``viscy_tpu/data/schemas.py``), on
the pydantic-free :class:`~viscy_tpu_torch.apps.airtable_utils.schemas.Model`:
pydantic's lax checks, and ``ValueError`` naming the model and the field
where pydantic raises."""

from __future__ import annotations

from viscy_tpu_torch.apps.airtable_utils.schemas import REQUIRED, Model, as_float, as_str, list_of, optional

__all__ = ["FOVRecord"]

_OPT_STR, _OPT_FLOAT = optional(as_str), optional(as_float)


class FOVRecord(Model):
    """One field of view's curation metadata (shared by the Airtable sync
    and collections)."""

    fields = (
        ("fov_name", as_str, REQUIRED),
        ("store_path", as_str, REQUIRED),
        ("well", _OPT_STR, None),
        ("channel_names", list_of(as_str), list),
        ("perturbation", _OPT_STR, None),
        ("cell_line", _OPT_STR, None),
        ("marker", _OPT_STR, None),
        ("organelle", _OPT_STR, None),
        ("microscope", _OPT_STR, None),
        ("pixel_size_xy_um", _OPT_FLOAT, None),
        ("pixel_size_z_um", _OPT_FLOAT, None),
        ("interval_minutes", _OPT_FLOAT, None),
        ("hours_post_perturbation_start", _OPT_FLOAT, None),
        ("quality", _OPT_STR, None),
        ("notes", _OPT_STR, None),
    )
