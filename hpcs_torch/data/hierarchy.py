"""PartNet's part hierarchy as per-level branch lists, for the hierarchical
CosFace loss (as the JAX package's).

`hierarchy_root` holds `{category}.txt`, the tree (one node per line, the
leaves marked 'leaf'), and `{category}-level-{L}.txt`, one "NN name" line
per node of level L.  Each level becomes a list of branches, each branch
the sorted leaf ids under it; leaf ids are then renumbered 0, 1, ... in
order within each level.
"""
import os


def get_leaves(hierarchy_root, category):
    with open(os.path.join(hierarchy_root, f"{category}.txt")) as fin:
        lines_hier = fin.readlines()
    leaves = [i + 1 for i, line in enumerate(lines_hier) if "leaf" in line]
    return leaves, lines_hier


def get_hierarchy_level(leaves, lines_level, lines_hier):
    numbers = [int(line[:2]) for line in lines_level]
    numbers.append(len(lines_hier) + 1)
    level_numbers = [list(range(numbers[i], numbers[i + 1])) or [numbers[i]]
                     for i in range(len(numbers) - 1)]
    return [sorted(set(item) & set(leaves)) for item in level_numbers]


def remap_leaves(hierarchy_list):
    """Relabel the leaf ids of each level to 0, 1, ... in traversal order."""
    remapped = []
    for branch in hierarchy_list:
        i, new_branch = 0, []
        for channel in branch:
            new_branch.append(list(range(i, i + len(channel))))
            i += len(channel)
        remapped.append(new_branch)
    return remapped


def get_hierarchy_list(hierarchy_root, category, levels):
    leaves, lines_hier = get_leaves(hierarchy_root, category)
    hierarchy_list = []
    for level in levels:
        with open(os.path.join(hierarchy_root, f"{category}-level-{level}.txt")) as fin:
            lines_level = fin.readlines()
        hierarchy_list.append(get_hierarchy_level(leaves, lines_level, lines_hier))
    return remap_leaves(hierarchy_list)
