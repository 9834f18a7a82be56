"""Recipes of the port: one reference entry-point script each. The
training slice brings the MT recipe (``recipes.translation``)."""
