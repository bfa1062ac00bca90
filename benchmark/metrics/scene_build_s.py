"""Seconds the set-up spent building the program's scene: the mesh, material
and light tables, the atlas (Textures.from_images) and prepare_scene's BVH
build and packing, on the host."""


def read(t):
    return t.setup.get("scene_build_s")
