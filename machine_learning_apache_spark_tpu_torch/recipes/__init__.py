"""Recipes of the port: one reference entry-point script each — the MT
recipe (``recipes.translation``) and the zoo's MLP, CNN and LSTM recipes
(``recipes.mlp``, ``recipes.cnn``, ``recipes.lstm``)."""
