"""Placement fixture: the port's other sinks and device values (against
injected ``lanes=(...::Lane.stage,)``, ``sync_points=(...::Lane.drain,)``,
``entry_names={"kernel_entry"}``)."""
import torch


def kernel_entry(x):
    return x


def produce(x):
    dev = kernel_entry(x)
    return dev


class Lane:
    def stage(self, batch, event, device):
        moved = batch.to(device)
        rows = moved.tolist()  # DP001: .to(device) made a device value
        got = produce(batch)
        arr = got.numpy()  # DP001: a producer's result, through .numpy()
        torch.cuda.synchronize()  # DP001: the whole device waits
        event.synchronize()  # DP001: an event wait outside SYNC_POINTS
        for _ in range(2):
            z = produce(batch)
            z.cpu()  # DP002: a copy back per launch
        self.quiet(batch)
        return rows, arr, self.drain(moved)

    def quiet(self, batch):
        d = batch.cuda()
        flag = bool(d)  # bool() is a deliberate, legal scalar sync
        host = torch.empty(4, pin_memory=False)
        host.copy_(d, non_blocking=True)  # an async copy is no sink
        return flag, host

    def drain(self, out):
        torch.cuda.synchronize()  # the declared sync point: legal site
        return out.cpu()
