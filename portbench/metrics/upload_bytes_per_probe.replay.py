"""Host bytes uploaded to the card for the decode, a probe (the program's
``decode.upload.bytes`` counter over the window; a device route tensor
already on the card is not counted)."""


def read(obs):
    n = obs.counters.get("decode.upload.bytes")
    if n is None or obs.work <= 0:
        return None
    return n / obs.work
