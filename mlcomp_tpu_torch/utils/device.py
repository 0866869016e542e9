"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: a
``cuda`` device without CUDA raises here, it never carries on quietly on
the CPU.
"""

import torch


def resolve_device(device='cuda') -> torch.device:
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {str(device)!r} asked for, but CUDA is not available '
            f"in this process — pass device='cpu' to run on the CPU")
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def device_info(device: torch.device) -> dict:
    """``{'platform': 'gpu'|'cpu', 'device': name}`` for /health."""
    if device.type == 'cuda':
        return {'platform': 'gpu',
                'device': torch.cuda.get_device_name(device)}
    return {'platform': 'cpu', 'device': 'cpu'}


__all__ = ['resolve_device', 'device_info']
