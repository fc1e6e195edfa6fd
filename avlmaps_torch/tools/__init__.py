"""The port's tools: command-line programs over ``avlmaps_torch``, each the
counterpart of one under the repository's ``tools/``.

    python -m avlmaps_torch.tools.recall_parity --tiny --device cpu
    python -m avlmaps_torch.tools.loc_eval --device cpu
    python -m avlmaps_torch.tools.planner_eval
    python -m avlmaps_torch.tools.pack_scene DATA_DIR
"""
