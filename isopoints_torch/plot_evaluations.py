"""Evaluation CSVs (metrics over checkpoints) as HTML line plots (port of
scripts/plot_evaluations.py).

    python -m isopoints_torch.plot_evaluations out/run/eval.csv [...] \
        [--out FILE.html]

Each CSV (a `mesh` column and one column a metric) becomes one figure with
a line a metric over the meshes; the figures go into one HTML file,
`--out` or the first CSV's name with .html (misc/visualize.py: data-only
HTML where plotly is not installed). `main(argv)` returns the path.
"""

import argparse
import csv
import os


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("csv_files", nargs="+")
    parser.add_argument("--out", type=str, default=None)
    args = parser.parse_args(argv)

    from isopoints_torch.misc.visualize import _go, figures_to_html

    go = _go()
    figs = []
    for path in args.csv_files:
        with open(path) as f:
            rows = list(csv.DictReader(f))
        if not rows:
            continue
        metrics = [k for k in rows[0] if k != "mesh"]
        fig = go.Figure(data=[
            go.Scatter(x=[r["mesh"] for r in rows],
                       y=[float(r[m]) for r in rows],
                       name=m, mode="lines+markers")
            for m in metrics])
        fig.update_layout(title=os.path.basename(path))
        figs.append(fig)
    out = args.out or os.path.splitext(args.csv_files[0])[0] + ".html"
    figures_to_html(figs, out)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
