"""The frozen scene code: the glTF loader and its PNG and JPEG decoders,
compile_scene, the procedural colonnade and its Sponza texture set, the
resize, and the uniform-grid acceleration structure."""
