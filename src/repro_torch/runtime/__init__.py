"""The training runtime: scheduler allocations bound to devices
(``elastic.py``), failure detection (``fault.py``), straggler ejection
(``straggler.py``) and checkpoints (``checkpoint.py``); the cluster
dashboard (``dashboard.py``) and the replica-set orchestrator
(``orchestrator.py``). Ports of ``repro/runtime``'s modules of the same
names."""
