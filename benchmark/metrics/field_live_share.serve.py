"""Live surfels rendered over the rows the deformation field
evaluated, in the traced served views (%): render.live / field.rows."""
from benchlib.spans import field_live_share as read  # noqa: F401
