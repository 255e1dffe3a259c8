"""Interactive-loop support. Only the diagnostics panel's state machine
(``ui``) is ported; the renderer, camera, colors, terminal view and the
snapshot stream are not (ROADMAP A7)."""
