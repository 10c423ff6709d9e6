"""SCOPe batch placement and model serving on PyTorch and CUDA.

A port of two paths of ``repro`` to one NVIDIA GPU: the placement
pipeline (G-PART -> COMPREDICT -> OPTASSIGN -> billing, ``core/``) and the
model zoo's serving path (``models/``, ``serving/``, ``launch/serve.py``).
The package mirrors ``repro``'s layout; the placement modules take and
return numpy at their boundaries, the model modules tensors, so both
packages can be fed the same inputs. The overlap matrix, the batched
weighted-entropy features, flash attention, decode attention and the
Mamba2 SSD scan run as hand-written CUDA kernels (``kernels/csrc``);
every entry point runs on the card unless the caller passes
``device="cpu"``.
"""
