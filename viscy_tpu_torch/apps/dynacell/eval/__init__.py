"""Dynacell evaluation, the virtual-staining benchmark (counterpart of
``viscy_tpu/apps/dynacell/eval``):

- pixel tier (:mod:`.metrics`, :mod:`.spectral`): PCC, SSIM, NRMSE, PSNR,
  spectral PCC, the multiband EV score and FSC resolution, on the device in
  float64;
- mask tier (:mod:`.metrics`, :mod:`.instance_metrics`,
  :mod:`.segmentation`): binary Dice / IoU and Cellpose-style instance AP
  over the native watershed segmentation, on the host (its filters and
  distance transform on the device, :mod:`._ndimage`);
- feature tier (:mod:`.metrics`, :mod:`.features`,
  :mod:`.feature_metrics`, :mod:`.feature_select`, :mod:`.linear_probe`):
  per-cell CP features and deep embeddings scored by FID, KID,
  precision / recall, MIND and cosine, and FOV-grouped linear probes.

:mod:`.pipeline` runs them with the artifact cache of :mod:`.cache` and the
executor and timings of :mod:`.runtime`; :mod:`.cross_condition` probes
conditions against each other. Submodules import on use.
"""
