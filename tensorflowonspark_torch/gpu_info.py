"""The reference's ``gpu_info`` module, over :mod:`.chip_info`.

Reference anchor: ``tensorflowonspark/gpu_info.py::get_gpus``.  A copy of
``tensorflowonspark_tpu/gpu_info.py``: code that imported ``gpu_info``
keeps working and claims CUDA cards through the claim-file protocol of
:mod:`tensorflowonspark_torch.chip_info`.
"""

from __future__ import annotations

from tensorflowonspark_torch.chip_info import MAX_RETRIES  # noqa: F401
from tensorflowonspark_torch import chip_info


def get_gpus(num_gpu: int = 1, worker_index: int = -1, format=str,
             app_id: str | None = None):
    """Claim ``num_gpu`` CUDA cards; returns a CSV string of indices.

    Matches the reference signature (``gpu_info.py::get_gpus``) closely
    enough for drop-in use; on a card-less host returns an empty string.
    ``app_id`` scopes the claim directory (defaults to ``TFOS_APP_ID`` env,
    then ``"default"``); claims auto-release at process exit.
    """
    import os

    chips = chip_info.claim_chips(
        num_gpu,
        app_id=app_id or os.environ.get("TFOS_APP_ID", "default"),
        worker_tag=f"worker_{worker_index}",
    )
    csv = ",".join(str(c) for c in chips)
    return csv if format is str else chips
