"""Render passes — one module per reference pass (src/*.cpp)."""
