import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (HERE, os.path.join(os.path.dirname(HERE), "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

# the tests share the machine: a few threads each
torch.set_num_threads(min(2, torch.get_num_threads()))
