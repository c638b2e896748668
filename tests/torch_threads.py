"""One torch intra-op thread in each test process.

Every port test module (tests/test_torch_*.py) imports this module for
that side effect. The Tier-1 run puts six xdist workers on the machine's
cores; torch's default pool (one thread a core in each worker) spends more
on waking and spinning threads than the suite's small tensors give back
(the parity engine's published rows took 126 s on one worker with eight
threads and 8 s with one, on an 8-core CPU). tpuwave's XLA thread pool
is not affected.
"""

import torch

torch.set_num_threads(1)
