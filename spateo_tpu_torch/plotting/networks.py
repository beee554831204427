"""Network graph plotting (counterpart of `spateo_tpu.plotting.networks`;
reference spateo/plotting/static/networks.py:12 `PlotNetwork`, :419
`plot_network`).

The reference renders interactive plotly FigureWidgets; plotly is not
available in this environment, so traces are built as plotly-Scatter-shaped
dicts (same keys: x/y/mode/marker/line/hovertext/...) and composited with
matplotlib. The trace-construction semantics (node size/color methods,
per-style edge traces with up to four dash styles, invisible mid-edge label
nodes, DiGraph arrowheads scaled by median edge length) follow the
reference; the hover callbacks operate on the trace data directly so the
neighbor-highlight behavior is testable without a GUI event loop.

Host code, copied; matplotlib and networkx are imported inside the functions
that draw, since the GPU machine has no matplotlib.
"""

from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from .utils import _pyplot, resolve_cmap, save_return_show_fig_utils

_DASH_TO_MPL = {"solid": "-", "dash": "--", "dot": ":", "dashdot": "-."}


class PlotNetwork:
    """Sets up and configures nodes and edges to plot a network graph
    (parity: reference networks.py:12)."""

    def __init__(self, G, layout: Optional[str] = None):
        import networkx as nx

        self.G = G
        self.layout = layout
        if layout:
            self.pos_dict = self._apply_layout(G, layout)
        elif not nx.get_node_attributes(G, "pos"):
            self.pos_dict = self._apply_layout(G, "spring")
        else:
            self.pos_dict = nx.get_node_attributes(G, "pos")
        self.inverse_pos_dict = {(v[0], v[1]): k for k, v in self.pos_dict.items()}

    # `pos` alias kept for earlier revisions of this module
    @property
    def pos(self):
        return self.pos_dict

    def _apply_layout(self, G, layout):
        """Applies a layout to a Graph (reference networks.py:360)."""
        import networkx as nx

        layout_functions = {
            "random": nx.random_layout,
            "circular": nx.circular_layout,
            "kamada": nx.kamada_kawai_layout,
            "planar": nx.planar_layout,
            "spring": nx.spring_layout,
            "spectral": nx.spectral_layout,
            "spiral": nx.spiral_layout,
        }
        fn = layout_functions.get(layout, nx.spring_layout)
        pos_dict = fn(G)
        nx.set_node_attributes(G, pos_dict, "pos")
        return pos_dict

    def generate_node_traces(
        self,
        colorscale: str,
        colorbar_title: str,
        color_method: Union[str, List],
        node_label: Optional[str],
        node_text: Optional[List[str]],
        node_label_size: int,
        node_label_position: str,
        node_opacity: float,
        size_method: Union[str, List],
        show_colorbar: bool = True,
    ) -> dict:
        """Node trace (reference networks.py:44): size by 'degree' (+12) /
        'static' (28) / a node attribute / an explicit list; color by
        'degree' / attribute / list; hovertext carries name, degree, and the
        requested node properties."""
        node_trace = {
            "x": [],
            "y": [],
            "mode": "markers+text" if node_label else "markers",
            "text": [],
            "hovertext": [],
            "hoverinfo": "text",
            "textposition": node_label_position,
            "textfont": dict(size=node_label_size, color="black"),
            "showlegend": False,
            "marker": dict(
                showscale=show_colorbar,
                colorscale=colorscale,
                reversescale=True,
                color=[],
                size=[],
                colorbar=dict(thickness=15, title=colorbar_title, xanchor="left", titleside="right"),
                line_width=0,
                opacity=node_opacity,
            ),
        }
        for node in self.G.nodes():
            text = f"Node: {node}<br>Degree: {self.G.degree(node)}"
            x, y = self.G.nodes[node]["pos"]
            node_trace["x"].append(x)
            node_trace["y"].append(y)
            if node_label:
                node_trace["text"].append(self.G.nodes[node].get(node_label, node))
            if node_text:
                for prop in node_text:
                    text += f"<br></br>{prop}: {self.G.nodes[node].get(prop)}"
            node_trace["hovertext"].append(text.strip())

            if isinstance(size_method, (list, np.ndarray)):
                node_trace["marker"]["size"] = list(size_method)
            elif size_method == "degree":
                node_trace["marker"]["size"].append(self.G.degree(node) + 12)
            elif size_method == "static":
                node_trace["marker"]["size"].append(28)
            else:
                node_trace["marker"]["size"].append(self.G.nodes[node][size_method])

            if isinstance(color_method, (list, np.ndarray)):
                node_trace["marker"]["color"] = list(color_method)
            elif color_method == "degree":
                node_trace["marker"]["color"].append(self.G.degree(node))
            else:
                node_trace["marker"]["color"].append(
                    self.G.nodes[node][color_method] if color_method in self.G.nodes[node] else color_method
                )
        return node_trace

    def generate_edge_traces(
        self,
        edge_label: Optional[str],
        edge_label_size: int,
        edge_label_position: str,
        edge_text: Optional[List[str]],
        edge_attribute_for_linestyle: Optional[str] = None,
        edge_attribute_for_thickness: Optional[str] = None,
        add_text: bool = False,
    ):
        """Edge traces + invisible mid-edge label nodes (reference
        networks.py:137): one trace per edge, styled by up to four unique
        values of the linestyle attribute (solid/dash/dot/dashdot), width
        (2*attr)^2 when a thickness attribute is given."""
        edge_properties = {}
        if edge_attribute_for_linestyle is None:
            edge_attribute_for_linestyle = edge_label

        unique_values = list(
            {
                e[2].get(edge_attribute_for_linestyle)
                for e in self.G.edges(data=True)
                if e[2].get(edge_attribute_for_linestyle)
            }
        )[:4]
        _style_cycle = [
            dict(color="#888", dash="solid"),
            dict(color="#555", dash="dash"),
            dict(color="#222", dash="dot"),
            dict(color="#000", dash="dashdot"),
        ]
        styles = {v: _style_cycle[i] for i, v in enumerate(unique_values)}

        edge_traces = []
        created_styles = set()
        middle_node_trace = {
            "x": [],
            "y": [],
            "text": [],
            "mode": "markers",
            "hoverinfo": "text",
            "hovertext": [],
            "textposition": edge_label_position,
            "textfont": dict(size=edge_label_size, color="black"),
            "marker": dict(opacity=0),
            "showlegend": False,
        }
        for edge in self.G.edges(data=True):
            x0, y0 = self.G.nodes[edge[0]]["pos"]
            x1, y1 = self.G.nodes[edge[1]]["pos"]
            if edge_attribute_for_thickness is not None and edge[2].get(edge_attribute_for_thickness):
                thickness = (edge[2][edge_attribute_for_thickness] * 2) ** 2
            else:
                thickness = 1
            if edge_attribute_for_linestyle is not None and edge[2].get(edge_attribute_for_linestyle):
                style = styles.get(edge[2][edge_attribute_for_linestyle], {"color": "#888", "dash": "solid"})
            else:
                style = {"color": "#888", "dash": "solid"}
            style_key = (style["color"], style["dash"])
            edge_traces.append(
                {
                    "x": (x0, x1, None),
                    "y": (y0, y1, None),
                    "line": dict(width=thickness, color=style["color"], dash=style["dash"]),
                    "hoverinfo": "text",
                    "mode": "lines",
                    "name": edge[2].get(edge_attribute_for_linestyle, "Unknown Linestyle"),
                    "showlegend": style_key not in created_styles,
                }
            )
            created_styles.add(style_key)

            if edge_text or edge_label:
                edge_pair = (edge[0], edge[1])
                if edge_pair not in edge_properties:
                    edge_properties[edge_pair] = {}
                    middle_node_trace["x"].append((x0 + x1) / 2)
                    middle_node_trace["y"].append((y0 + y1) / 2)
                if edge_text:
                    for prop in edge_text:
                        edge_properties[edge_pair].setdefault(prop, []).append(edge[2].get(prop))
            if add_text and edge_label:
                middle_node_trace["text"].append(edge[2].get(edge_label))
                middle_node_trace["mode"] = "markers+text"

        if edge_text:
            middle_node_trace["hovertext"] = [
                "\n".join(f"{k}: {v}" for k, v in vals.items()) for _, vals in edge_properties.items()
            ]
        return edge_traces, middle_node_trace

    def generate_figure(
        self,
        node_trace: dict,
        edge_traces: List[dict],
        middle_node_trace: dict,
        title: str,
        title_font_size: int,
        arrow_size: float,
        transparent_background: bool,
        highlight_neighbors_on_hover: bool,
        upper_margin: float = 40,
        lower_margin: float = 20,
        left_margin: float = 50,
        right_margin: float = 50,
        ax=None,
    ):
        """Composite the traces into a figure (reference networks.py:257).

        Rendered with matplotlib: per-style edge lines (legend shows each
        style once), node scatter colored through `colorscale`, invisible
        mid-edge markers realized as text annotations, and — for DiGraphs —
        arrowheads placed along each edge at 0.5/0.9 of its length depending
        on whether the edge is shorter/longer than the median (the
        reference's quiver placement rule)."""
        plt = _pyplot()

        if ax is None:
            px = 1 / 72.0
            fig, ax = plt.subplots(figsize=(7, 6))
            fig.subplots_adjust(
                left=left_margin * px / 7,
                right=1 - right_margin * px / 7,
                top=1 - upper_margin * px / 6,
                bottom=lower_margin * px / 6,
            )
        else:
            fig = ax.figure
        self.fig, self.ax = fig, ax

        seen_names = set()
        for tr in edge_traces:
            xs = [v for v in tr["x"] if v is not None]
            ys = [v for v in tr["y"] if v is not None]
            label = str(tr["name"]) if tr.get("showlegend") and tr.get("name") not in seen_names else None
            if label is not None:
                seen_names.add(tr.get("name"))
            ax.plot(
                xs,
                ys,
                linestyle=_DASH_TO_MPL.get(tr["line"]["dash"], "-"),
                color=tr["line"]["color"],
                linewidth=min(tr["line"]["width"], 8.0),
                alpha=0.7,
                label=label,
                zorder=1,
            )

        cvals = node_trace["marker"]["color"]
        sizes = np.asarray(node_trace["marker"]["size"], float)
        sizes_pt = sizes**2 * 0.35  # plotly diameter-px -> mpl pt^2 (approx)
        numeric = np.issubdtype(np.asarray(cvals).dtype, np.number)
        if numeric:
            cmap = resolve_cmap(node_trace["marker"]["colorscale"])
            if node_trace["marker"].get("reversescale"):
                cmap = cmap.reversed()
            sc = ax.scatter(
                node_trace["x"], node_trace["y"], s=sizes_pt, c=np.asarray(cvals, float),
                cmap=cmap, alpha=node_trace["marker"]["opacity"], zorder=2,
            )
            if node_trace["marker"].get("showscale"):
                cb = fig.colorbar(sc, ax=ax, shrink=0.7)
                cb.set_label(node_trace["marker"]["colorbar"].get("title") or "")
        else:
            ax.scatter(
                node_trace["x"], node_trace["y"], s=sizes_pt, c=list(cvals),
                alpha=node_trace["marker"]["opacity"], zorder=2,
            )
        if "text" in node_trace.get("mode", ""):
            va = {"top": "bottom", "middle": "center", "bottom": "top"}
            pos_v = node_trace["textposition"].split()[0] if node_trace.get("textposition") else "top"
            for x, y, t in zip(node_trace["x"], node_trace["y"], node_trace["text"]):
                ax.annotate(
                    str(t), (x, y), fontsize=node_trace["textfont"]["size"],
                    color=node_trace["textfont"]["color"], ha="center",
                    va=va.get(pos_v, "bottom"), zorder=3,
                )
        if "text" in middle_node_trace.get("mode", ""):
            for x, y, t in zip(middle_node_trace["x"], middle_node_trace["y"], middle_node_trace["text"]):
                ax.annotate(str(t), (x, y), fontsize=middle_node_trace["textfont"]["size"],
                            color=middle_node_trace["textfont"]["color"], ha="center", va="center", zorder=3)

        import networkx

        if isinstance(self.G, networkx.DiGraph):
            edge_lengths = [
                np.linalg.norm(np.array(self.G.nodes[e[1]]["pos"]) - np.array(self.G.nodes[e[0]]["pos"]))
                for e in self.G.edges()
            ]
            median_length = np.median(edge_lengths) if edge_lengths else 0.0
            for e in self.G.edges():
                start = np.array(self.G.nodes[e[0]]["pos"], float)
                end = np.array(self.G.nodes[e[1]]["pos"], float)
                direction = end - start
                length = np.linalg.norm(direction)
                if length == 0:
                    continue
                scale_factor = 0.5 if length <= median_length else 0.9
                tip = start + scale_factor * direction
                d = direction / length * 0.01 * arrow_size
                ax.annotate(
                    "", xy=tip + d, xytext=tip - d,
                    arrowprops=dict(arrowstyle=f"-|>,head_width={0.15*arrow_size},head_length={0.3*arrow_size}",
                                    color="#444444", lw=1.5),
                    zorder=2,
                )

        if seen_names:
            ax.legend(fontsize=8, loc="upper right")
        ax.set_title(title, fontsize=title_font_size)
        ax.set_xticks([])
        ax.set_yticks([])
        for s in ax.spines.values():
            s.set_visible(False)
        if transparent_background:
            fig.patch.set_alpha(0.0)
            ax.patch.set_alpha(0.0)
        if highlight_neighbors_on_hover:
            self.original_node_trace = {**node_trace, "marker": dict(node_trace["marker"])}
        self.f = fig
        return fig

    def on_hover(self, trace: dict, points) -> dict:
        """Neighbor-highlight on hover (reference networks.py:380): every
        node except the hovered one and its graph neighbors is greyed to
        #E4E4E4. `points` carries `point_inds`/`xs`/`ys` like a plotly
        callback; operates on (and returns) the trace dict so the behavior
        is testable headlessly."""
        point_inds = getattr(points, "point_inds", None) or (points.get("point_inds") if isinstance(points, dict) else None)
        if not point_inds:
            return trace
        xs = getattr(points, "xs", None) or points.get("xs")
        ys = getattr(points, "ys", None) or points.get("ys")
        node = self.inverse_pos_dict[(xs[0], ys[0])]
        neighbours = list(self.G.neighbors(node))
        node_colours = list(trace["marker"]["color"])
        new_colors = ["#E4E4E4"] * len(node_colours)
        new_colors[point_inds[0]] = node_colours[point_inds[0]]
        for neighbour in neighbours:
            trace_position = list(self.pos_dict).index(neighbour)
            new_colors[trace_position] = node_colours[trace_position]
        trace["marker"]["color"] = new_colors
        return trace

    def on_unhover(self, trace: dict, points=None) -> dict:
        """Restore the pre-hover node colors/sizes (reference networks.py:403)."""
        trace["marker"]["color"] = list(self.original_node_trace["marker"]["color"])
        trace["marker"]["size"] = list(self.original_node_trace["marker"]["size"])
        return trace

    def draw(
        self,
        ax=None,
        title: str = "",
        size_method="degree",
        color_method="degree",
        node_label: Optional[str] = None,
        node_label_position: str = "top center",
        node_text: Optional[List[str]] = None,
        nodefont_size: int = 8,
        edge_label: Optional[str] = None,
        edge_thickness_attr: Optional[str] = None,
        edge_label_position: str = "middle center",
        edge_text: Optional[List[str]] = None,
        edgefont_size: int = 8,
        titlefont_size: int = 16,
        show_colorbar: bool = True,
        colorscale: str = "YlGnBu",
        colorbar_title: Optional[str] = None,
        node_opacity: float = 0.8,
        arrow_size: float = 2,
        transparent_background: bool = True,
        highlight_neighbors_on_hover: bool = True,
        upper_margin: float = 40,
        lower_margin: float = 20,
        left_margin: float = 50,
        right_margin: float = 50,
    ):
        """Trace pipeline + figure compositing in one call."""
        node_trace = self.generate_node_traces(
            colorscale, colorbar_title or "", color_method, node_label, node_text,
            nodefont_size, node_label_position, node_opacity, size_method, show_colorbar,
        )
        edge_traces, middle_node_trace = self.generate_edge_traces(
            edge_label, edgefont_size, edge_label_position, edge_text,
            edge_attribute_for_thickness=edge_thickness_attr, add_text=edge_label is not None,
        )
        self.generate_figure(
            node_trace, edge_traces, middle_node_trace, title, titlefont_size, arrow_size,
            transparent_background, highlight_neighbors_on_hover,
            upper_margin, lower_margin, left_margin, right_margin, ax=ax,
        )
        return self.ax


def plot_network(
    G,
    title: str,
    size_method: Union[str, List[float]] = "degree",
    color_method: Union[str, List[str]] = "degree",
    layout: Optional[str] = None,
    node_label: Optional[str] = None,
    node_label_position: str = "top center",
    node_text: Optional[List[str]] = None,
    nodefont_size: int = 8,
    edge_label: Optional[str] = None,
    edge_thickness_attr: Optional[str] = None,
    edge_label_position: str = "middle center",
    edge_text: Optional[List[str]] = None,
    edgefont_size: int = 8,
    titlefont_size: int = 16,
    show_colorbar: bool = True,
    colorscale: str = "YlGnBu",
    colorbar_title: Optional[str] = None,
    node_opacity: float = 0.8,
    arrow_size: float = 2,
    transparent_background: bool = False,
    highlight_neighbors_on_hover: bool = False,
    upper_margin: float = 40,
    lower_margin: float = 20,
    left_margin: float = 50,
    right_margin: float = 50,
    ax=None,
    save_show_or_return: str = "return",
    save_kwargs: Optional[dict] = None,
    **kwargs,
):
    """Intercellular GRN / interaction network plot (parity: reference
    networks.py:419; plotly interactivity replaced by matplotlib compositing
    of the same traces)."""
    pn = PlotNetwork(G, layout=layout)
    ax = pn.draw(
        ax=ax, title=title, size_method=size_method, color_method=color_method,
        node_label=node_label, node_label_position=node_label_position, node_text=node_text,
        nodefont_size=nodefont_size, edge_label=edge_label,
        edge_thickness_attr=edge_thickness_attr, edge_label_position=edge_label_position,
        edge_text=edge_text, edgefont_size=edgefont_size,
        titlefont_size=titlefont_size, show_colorbar=show_colorbar, colorscale=colorscale,
        colorbar_title=colorbar_title, node_opacity=node_opacity, arrow_size=arrow_size,
        transparent_background=transparent_background,
        highlight_neighbors_on_hover=highlight_neighbors_on_hover,
        upper_margin=upper_margin, lower_margin=lower_margin,
        left_margin=left_margin, right_margin=right_margin,
    )
    return save_return_show_fig_utils(save_show_or_return, False, None, "network", save_kwargs, 1, ax.figure, ax)
