"""The single-device entry: ``new_cg_variants_tpu_torch.solve`` with the
mix's variant, norm type, iteration cap and tolerance, one call a right-hand
side, ending when the card has finished it."""

import torch

KEYS = ("variant", "norm_type", "max_iter", "rtol")


def prepare(op, mix, device):
    from new_cg_variants_tpu_torch import solve

    kw = {k: mix[k] for k in KEYS if k in mix}
    wait = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))

    def call(b):
        res = solve(op, b, device=device, **kw)
        wait()
        return res

    return call
