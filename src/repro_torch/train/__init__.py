"""Step functions of the serving path (``repro.train``'s counterpart; the
training step and loop come with ``ROADMAP.md`` A10 slice 2)."""

from repro_torch.train.steps import make_prefill_step, make_serve_step, pad_caches

__all__ = ["make_prefill_step", "make_serve_step", "pad_caches"]
