"""The multi-device engine over torch.distributed: the process group
(mesh), the plan's collectives (comm) and the sharded BCR build (sharded)."""
