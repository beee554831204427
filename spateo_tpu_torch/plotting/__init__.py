"""Plotting (`st.pl`): the categorical palettes (`colorlabel`), the shared
helpers (`utils`) and the 3D renderer (`three_d_plot.three_dims_plotter`)
are ported, with matplotlib imported inside the functions that draw; the
plot functions are ROADMAP Queue 1 item 15."""

from . import colorlabel, three_d_plot, utils
