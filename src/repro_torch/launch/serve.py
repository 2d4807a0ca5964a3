"""Deprecated alias for :mod:`repro_torch.launch.inference_demo`.

The port of ``repro.launch.serve``: the batched **LLM inference** demo
under its old name, which invited confusion with the FedZero scheduler
service (:mod:`repro_torch.service`, driver ``python -m
repro_torch.service``). The demo lives at
:mod:`repro_torch.launch.inference_demo`; this shim keeps old imports and
``python -m repro_torch.launch.serve`` invocations working, with a
:class:`DeprecationWarning`.
"""
from __future__ import annotations

import warnings

from .inference_demo import main  # noqa: F401  (re-export)

warnings.warn(
    "repro_torch.launch.serve is deprecated: the batched LLM-inference demo "
    "moved to repro_torch.launch.inference_demo (the FedZero scheduler "
    "service is `python -m repro_torch.service`)",
    DeprecationWarning, stacklevel=2)

if __name__ == "__main__":
    main()
