"""The process group that the sharded engine runs over (counterpart of
ropebwt2_tpu/parallel/mesh.py).

The JAX package shards its state over a device mesh inside one program.
Under torch.distributed each shard is a process: rank s of a world of d
owns shard s, on its own device.  A Mesh names that group, this rank, the
world size and the device.  The backend is NCCL on a CUDA device and gloo
only when the caller asks for the CPU; there is no fallback from one to
the other.
"""

import dataclasses
import os
import typing

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    group: typing.Any  # the process group; None is the default group
    s: int  # this rank
    d: int  # ranks (shards)
    device: torch.device
    owns_group: bool  # make_mesh started the default group (close() ends it)
    # the (hosts, shards) DeviceMesh of make_mesh2d; the engine runs over
    # its flattened, host-major ranks
    device_mesh: typing.Any = None

    def close(self):
        """End the 2-D mesh's subgroups, then the default group if
        make_mesh started it, so that no gloo or NCCL group outlives the
        mesh (a subgroup left live at a rank's exit can abort it)."""
        if self.device_mesh is not None and dist.is_initialized():
            for dim in range(self.device_mesh.ndim):
                group = self.device_mesh.get_group(dim)
                if group is not dist.GroupMember.WORLD:
                    dist.destroy_process_group(group)
        self.device_mesh = None
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def _device(device):
    """The rank's device: cuda:LOCAL_RANK by default, which raises when
    there is no card; device="cpu" for gloo ranks on the CPU."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the sharded engine: no CUDA device; pass device='cpu' to run "
            "its ranks on the CPU over gloo")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def make_mesh(n_devices=None, device=None) -> Mesh:
    """The default process group as a mesh of its ranks.  It is started
    here if it is not yet: from the torchrun environment when WORLD_SIZE is
    set (init_method env://), else as a world of one.  ``n_devices``, when
    given, must equal the world size."""
    device = _device(device)
    backend = "gloo" if device.type == "cpu" else "nccl"
    owns = not dist.is_initialized()
    if owns:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
    elif dist.get_backend() != backend:
        raise ValueError(f"the process group runs {dist.get_backend()}, and "
                         f"a {device.type} shard needs {backend}")
    mesh = Mesh(group=None, s=dist.get_rank(), d=dist.get_world_size(),
                device=device, owns_group=owns)
    if n_devices is not None and n_devices != mesh.d:
        mesh.close()
        raise ValueError(f"a mesh of {n_devices} devices in a world of "
                         f"{mesh.d}")
    return mesh


def make_mesh2d(hosts, shards, device=None) -> Mesh:
    """A (hosts, shards) mesh, host-major (rank = host * shards + shard), so
    that consecutive BWT ranges stay within a host.  The engine runs over
    its flattened ranks, which are the default group's in order, as the
    JAX engine runs over the flattened axis tuple."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = make_mesh(hosts * shards, device)
    mesh.device_mesh = init_device_mesh(
        mesh.device.type, (hosts, shards), mesh_dim_names=("h", "s"))
    return mesh


def local_block(x, mesh: Mesh):
    """This rank's block of a host array split evenly along axis 0 (what
    shard_state / shard_reads place on each device in the JAX package)."""
    n = x.shape[0]
    if n % mesh.d:
        raise ValueError(f"{n} rows do not split over {mesh.d} ranks")
    b = n // mesh.d
    return x[mesh.s * b: (mesh.s + 1) * b]
