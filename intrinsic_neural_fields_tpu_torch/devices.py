"""Device lists: the devices a data-parallel run or a D-way render spans,
and the context that sends the port's launches to one of them. It sits
below render, eval and train, which all read it, and imports none of them."""
from __future__ import annotations

import contextlib

import torch

from . import resolve_device


def resolve_devices(devices):
    """The device list of a data-parallel run: a count D (cuda:0 ...
    cuda:D-1) or a list of device names, in which a device may repeat.
    Raises when a CUDA device is asked for that this machine does not have
    (JAX make_device_mesh asserts the same); never drops to fewer devices
    or to the CPU."""
    if isinstance(devices, int):
        if devices < 1:
            raise ValueError(f"need at least one device, got {devices}")
        devices = [f"cuda:{i}" for i in range(devices)]
    devs = []
    for name in devices:
        dev = resolve_device(name)
        if dev.type == "cuda":
            index = torch.cuda.current_device() if dev.index is None else dev.index
            have = torch.cuda.device_count()
            if index >= have:
                raise RuntimeError(f"requested {len(devices)} devices ({list(devices)}), only "
                                   f"{have} CUDA device(s) available")
            dev = torch.device("cuda", index)
        devs.append(dev)
    if not devs:
        raise ValueError("the device list is empty")
    return devs


def cli_devices(device, num_devices):
    """The device list of a CLI's --device and --num_devices: None for one
    device; for --device cpu, the CPU D times; else cuda:0 ... cuda:D-1,
    which raises when this machine has fewer CUDA devices."""
    if num_devices < 1:
        raise ValueError(f"--num_devices must be at least 1, got {num_devices}")
    if num_devices == 1:
        return None
    if resolve_device(device).type == "cpu":
        return resolve_devices(["cpu"] * num_devices)
    return resolve_devices(num_devices)


def device_scope(dev):
    """A context in which launches go to `dev`: the port's kernels launch on
    the current CUDA device."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def device_of(t):
    """The device of tensor `t` as a device list names it (a CUDA device
    with its index)."""
    dev = t.device
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
