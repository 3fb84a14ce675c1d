"""Model pieces of the port."""
from .rope import apply_rope, apply_rope_grid, apply_rope_rows

__all__ = ["apply_rope", "apply_rope_grid", "apply_rope_rows"]
