"""Plotting (`st.pl`): only the categorical palettes are ported
(`colorlabel`); the plot functions are ROADMAP Queue 1 item 15."""

from . import colorlabel
