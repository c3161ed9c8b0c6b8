"""``python -m viscy_tpu_torch.apps.cytoland`` runs the shared ``viscy-torch``
CLI (counterpart of ``viscy_tpu/apps/cytoland/__main__.py``)."""

from viscy_tpu_torch.training.cli import main

if __name__ == "__main__":
    main()
