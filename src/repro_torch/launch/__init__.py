"""Launchers of the LM scaffold (``repro.launch``'s counterpart): the
serving launcher ``repro_torch.launch.serve``."""
