"""Launchers of the port: the end-to-end training driver (``train``; run
it as ``python -m repro_torch.launch.train``). The reference's dry run,
mesh, hardware constants and analysis wait for ROADMAP item 14e, its
hill-climb for 13b."""

__all__ = ["train"]
