"""Realistic segmentation simulation + evaluation
(capability parity: reference spateo/segmentation/simulation_evaluation/
{prepare,allocate_cell,evaluation}.py)."""

from .allocate_cell import Cell, add_sig_to_cell, get_cell_pos, simulate_cell_and_sig
from .evaluation import cal_ami, cal_f1score, cal_precision
from .prepare import c_to_a_ratio_dis, cell_area_dis, get_fb_dis, get_fb_dis_window, ltos_ratio_dis
