"""SCOPe batch placement on PyTorch and CUDA.

A port of ``repro``'s placement pipeline (G-PART -> COMPREDICT ->
OPTASSIGN -> billing) that runs on one NVIDIA GPU. The package mirrors
``repro``'s layout (``core/``, ``data/``, ``storage/``, ``kernels/``) and
takes and returns numpy at module boundaries, so both packages can be fed
the same inputs. The fractional-overlap matrix and the batched
weighted-entropy features run as hand-written CUDA kernels
(``kernels/csrc``); every entry point runs on the card unless the caller
passes ``device="cpu"``.
"""
