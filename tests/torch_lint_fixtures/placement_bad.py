"""Placement fixture: the JAX package's placement_bad.py in torch idiom,
line for line (against injected ``lanes=(...::Lane.stage,)``,
``sync_points=(...::Lane.drain,)``, ``entry_names={"kernel_entry"}``)."""
import numpy as np


def kernel_entry(x):
    return x


class Lane:
    def stage(self, batch):
        out = kernel_entry(batch)
        host = out.cpu()  # DP001: a copy to the host outside SYNC_POINTS
        for _ in range(3):
            y = kernel_entry(batch)
            val = float(y)  # DP002: host cast inside a launching loop
        arr = np.zeros(4)
        res = kernel_entry(arr)  # DP003: bare numpy array into a kernel
        return self.helper(), host, val, res

    def helper(self):
        d = kernel_entry(np.ones(2))
        return d.item()  # DP001: reachable helper reads its launch

    def drain(self, out):
        return out.cpu().numpy()  # the declared sync point: legal site
