"""The raster layer: SoA front end, pair rows, the G-buffer kernel (K1),
texture sampling and the window-gather kernels (K4/K5/K6)."""
