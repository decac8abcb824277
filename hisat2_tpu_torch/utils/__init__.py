from . import alphabet  # noqa: F401


def resolve_device(device):
    """torch.device(device) for an entry point. A CUDA device with no card
    present raises: no entry point falls back to the CPU."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but no CUDA device is available "
            f"(pass device='cpu', or --device cpu, to run on the CPU)")
    return dev
