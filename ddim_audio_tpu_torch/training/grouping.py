"""Parameter grouping by top-level key (port of
``ddim_audio_tpu/training/grouping.py``): each config group lists
``top_level_name`` prefixes; a parameter whose top-level name matches joins
that group, everything else falls to ``"default"``; empty groups are dropped.
With audio.yml, ``transformer`` → the AdamW group and everything else → the
AdaBelief ``default`` group; both ``grad_norm`` groups list no
``top_level_name``, so all parameters clip together in ``default``."""

from __future__ import annotations


def classify_top_level(groups_cfg) -> dict:
    """{top_level_name: group_name} from a config namespace of groups."""
    mapping = {}
    for group_name, sub in vars(groups_cfg).items():
        for top in getattr(sub, "top_level_name", []) or []:
            mapping[top] = group_name
    return mapping


def group_labels(groups_cfg, params):
    """({top_level_key: group_name}, {group_name: group_cfg}) for a param
    tree; only groups that own a parameter survive."""
    mapping = classify_top_level(groups_cfg)
    labels = {top: mapping.get(top, "default") for top in params}
    used = set(labels.values())
    groups = {name: sub for name, sub in vars(groups_cfg).items()
              if name in used}
    return labels, groups
