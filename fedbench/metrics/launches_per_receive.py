"""Kernel launches on the device in the traced window (copies apart) per
client update that ``receives_per_s`` counts."""


def read(rec):
    tr = rec["trace"]
    if tr is None or tr["kernel_launches"] == 0 or rec["receives"] == 0:
        return None
    return tr["kernel_launches"] / rec["receives"]
