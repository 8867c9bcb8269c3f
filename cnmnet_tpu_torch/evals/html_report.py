"""HTML galleries over per-frame eval artifacts.

The reference ships vendored PlaneRCNN report writers (`writeHTML` /
`writeHTMLComparison`, `data_prepare/utils.py:1213-1278`) that tabulate
per-frame PNGs into a browsable page. This is their counterpart over OUR
artifact layout (`evals/seven_scenes_eval.py:_save_frame_artifacts`:
``save_dir/scene/seq/<kind>/<frame>.<suffix>.png``), written with plain
stdlib string assembly — no html library, no imgkit.

Two entry points:

* :func:`write_report` — one run dir -> ``index.html`` per sequence (a row
  per frame, a column per artifact kind) + a top-level index of sequences;
* :func:`write_comparison` — N run dirs over the same sequences -> side by
  side columns per run, for A/B-ing checkpoints or configs.

The port's copy of ``cnmnet_tpu/evals/html_report.py``.
"""

from __future__ import annotations

import html
import os
from typing import Dict, List, Sequence

KINDS = ("rgb", "gt_depth", "pred_depth", "pred_normal", "prob_map")

_STYLE = """
body { font-family: sans-serif; background: #111; color: #ddd; }
table { border-collapse: collapse; }
td, th { border: 1px solid #444; padding: 2px 6px; text-align: center; }
img { display: block; }
a { color: #8cf; }
"""


def _page(title: str, body: str) -> str:
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{html.escape(title)}</title><style>{_STYLE}</style></head>"
        f"<body><h2>{html.escape(title)}</h2>{body}</body></html>"
    )


def _frames(seq_dir: str) -> Dict[str, Dict[str, str]]:
    """frame name -> {kind: relative png path} for one sequence dir."""
    frames: Dict[str, Dict[str, str]] = {}
    for kind in KINDS:
        d = os.path.join(seq_dir, kind)
        if not os.path.isdir(d):
            continue
        for f in os.listdir(d):
            if not f.endswith(".png"):
                continue
            name = f.split(".")[0]
            frames.setdefault(name, {})[kind] = os.path.join(kind, f)
    return frames


def _sequences(run_dir: str) -> List[str]:
    """Relative scene/seq paths that contain artifact kind dirs."""
    seqs = []
    for scene in sorted(os.listdir(run_dir)):
        sdir = os.path.join(run_dir, scene)
        if not os.path.isdir(sdir):
            continue
        for seq in sorted(os.listdir(sdir)):
            qdir = os.path.join(sdir, seq)
            if any(os.path.isdir(os.path.join(qdir, k)) for k in KINDS):
                seqs.append(os.path.join(scene, seq))
    return seqs


def _img_cell(src: str, width: int) -> str:
    w = f" width='{width}'" if width > 0 else ""
    return f"<td><img src='{html.escape(src)}'{w}></td>"


def write_report(run_dir: str, image_width: int = 256) -> List[str]:
    """Write index.html for every sequence + a run-level index.

    Returns the list of sequence page paths written.
    """
    pages = []
    seqs = _sequences(run_dir)
    for rel in seqs:
        seq_dir = os.path.join(run_dir, rel)
        frames = _frames(seq_dir)
        kinds = [k for k in KINDS if any(k in v for v in frames.values())]
        rows = ["<tr><th>frame</th>" + "".join(f"<th>{k}</th>" for k in kinds) + "</tr>"]
        for name in sorted(frames):
            cells = "".join(
                _img_cell(frames[name][k], image_width) if k in frames[name]
                else "<td>—</td>"
                for k in kinds
            )
            rows.append(f"<tr><td>{html.escape(name)}</td>{cells}</tr>")
        path = os.path.join(seq_dir, "index.html")
        with open(path, "w") as f:
            f.write(_page(rel, f"<table>{''.join(rows)}</table>"))
        pages.append(path)

    links = "".join(
        f"<li><a href='{html.escape(os.path.join(rel, 'index.html'))}'>"
        f"{html.escape(rel)}</a></li>"
        for rel in seqs
    )
    with open(os.path.join(run_dir, "index.html"), "w") as f:
        f.write(_page(os.path.basename(os.path.abspath(run_dir)), f"<ul>{links}</ul>"))
    return pages


def write_comparison(
    out_path: str,
    run_dirs: Sequence[str],
    labels: Sequence[str] | None = None,
    kinds: Sequence[str] = ("pred_depth", "pred_normal"),
    common_kinds: Sequence[str] = ("rgb", "gt_depth"),
    image_width: int = 256,
) -> str:
    """Side-by-side comparison page across run dirs (same sequence layout).

    Common kinds (rgb, gt) come from the first run; per-run kinds repeat for
    every run dir — the `writeHTMLComparison` use case. Image paths are
    written relative to ``out_path``'s directory.
    """
    labels = list(labels or run_dirs)
    base = os.path.dirname(os.path.abspath(out_path)) or "."
    first = run_dirs[0]
    sections = []
    for rel in _sequences(first):
        per_run = [_frames(os.path.join(rd, rel)) for rd in run_dirs]
        header = (
            "<tr><th>frame</th>"
            + "".join(f"<th>{k}</th>" for k in common_kinds)
            + "".join(
                f"<th>{html.escape(lb)}<br>{k}</th>" for lb in labels for k in kinds
            )
            + "</tr>"
        )
        rows = [header]
        for name in sorted(per_run[0]):
            cells = []
            for k in common_kinds:
                src = per_run[0][name].get(k)
                cells.append(
                    _img_cell(
                        os.path.relpath(os.path.join(first, rel, src), base),
                        image_width,
                    )
                    if src
                    else "<td>—</td>"
                )
            for rd, fr in zip(run_dirs, per_run):
                for k in kinds:
                    src = fr.get(name, {}).get(k)
                    cells.append(
                        _img_cell(
                            os.path.relpath(os.path.join(rd, rel, src), base),
                            image_width,
                        )
                        if src
                        else "<td>—</td>"
                    )
            rows.append(f"<tr><td>{html.escape(name)}</td>{''.join(cells)}</tr>")
        sections.append(
            f"<h3>{html.escape(rel)}</h3><table>{''.join(rows)}</table>"
        )
    with open(out_path, "w") as f:
        f.write(_page("comparison", "".join(sections)))
    return out_path
