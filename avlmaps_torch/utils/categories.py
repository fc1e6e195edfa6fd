"""Category label lists.

``MP3D_CATEGORIES`` is the standard Matterport3D 40-class label set (public
dataset metadata; reference avlmaps/utils/matterport3d_categories.py).
"""

MP3D_CATEGORIES = [
    "void", "wall", "floor", "chair", "door", "table", "picture", "cabinet",
    "cushion", "window", "sofa", "bed", "curtain", "chest_of_drawers",
    "plant", "sink", "stairs", "ceiling", "toilet", "stool", "towel",
    "mirror", "tv_monitor", "shower", "column", "bathtub", "counter",
    "fireplace", "lighting", "beam", "railing", "shelving", "blinds",
    "gym_equipment", "seating", "board_panel", "furniture", "appliances",
    "clothes", "objects",
]

# alias matching the reference's symbol name
mp3dcat = MP3D_CATEGORIES

# HM3D-semantics label list: empty in the reference too
# (hm3dsem_categories.py:1)
HM3DSEM_CATEGORIES: list = []
