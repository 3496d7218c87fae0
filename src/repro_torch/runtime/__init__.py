"""The training runtime: scheduler allocations bound to devices
(``elastic.py``), failure detection (``fault.py``), straggler ejection
(``straggler.py``) and checkpoints (``checkpoint.py``). Ports of
``repro/runtime``'s modules of the same names."""
