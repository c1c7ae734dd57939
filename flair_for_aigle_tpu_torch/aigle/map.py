"""Class mapping FLAIR -> Aigle app classes (reference utils/map.py)."""

from __future__ import annotations

import yaml

CATEGORIES_LABELS = {
    0: "construction en dur",
    1: "camping car",
    2: "caravane",
    3: "construction en dur",
    4: "container",
    5: "dechet",
    6: "installation legere",
    7: "mobil home",
    8: "navire",
    9: "panneau photovoltaique",
    10: "piscine",
    11: "pilone electrique",
    12: "reservoir d eau",
    13: "tunnel agricole serre",
    14: "station d epuration",
    15: "remblais",
    16: "plan d eau",
    17: "broussailles a risque",
}

# FLAIR 19-class -> minimal Aigle detection classes: keep only class 6
# (water) -> 16 ("plan d'eau"); everything else dropped (-1).
# Reference utils/map.py:63-84.
SIMPLIFY_FLAIR_TO_APP = {i: -1 for i in range(19)}
SIMPLIFY_FLAIR_TO_APP[6] = 16


class Mapper:
    def __init__(self, classes_file, simplify=False):
        self.simplify = simplify
        if not simplify and isinstance(classes_file, str):
            with open(classes_file) as cf:
                self.ml_project_classes = yaml.safe_load(cf)
        else:
            self.ml_project_classes = classes_file

    def map_aigle_classes_labels(self, x):
        return CATEGORIES_LABELS.get(x, "Unknown class")

    def simplify_flair_classes_app(self, x):
        return SIMPLIFY_FLAIR_TO_APP.get(x, -1)
