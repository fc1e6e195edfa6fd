"""Manual sound-category assignment UI.

Counterpart of ``avlmaps_tpu/utils/category_assigner.py``; reference
avlmaps/utils/category_assigner.py:10-89: a matplotlib button grid
for labelling ambiguous audio events with their category at given map
positions.  Re-designed with a headless-friendly core (assignments are plain
state transitions) and an optional matplotlib front-end.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class CategoryAssigner:
    """Assign one category per item (e.g. sound event at a map position)."""

    def __init__(self, categories: Sequence[str], items: Sequence[object]):
        self.categories = list(categories)
        self.items = list(items)
        self.assignments: Dict[int, str] = {}
        self.cursor = 0

    # -- headless core ------------------------------------------------------

    @property
    def current_item(self):
        return self.items[self.cursor] if self.cursor < len(self.items) \
            else None

    def assign(self, category: str) -> None:
        if category not in self.categories:
            raise ValueError(f"unknown category {category!r}")
        self.assignments[self.cursor] = category
        self.cursor = min(self.cursor + 1, len(self.items))

    def skip(self) -> None:
        self.cursor = min(self.cursor + 1, len(self.items))

    def back(self) -> None:
        self.cursor = max(self.cursor - 1, 0)

    @property
    def done(self) -> bool:
        return self.cursor >= len(self.items)

    def results(self) -> List[Tuple[object, Optional[str]]]:
        return [(item, self.assignments.get(i))
                for i, item in enumerate(self.items)]

    # -- matplotlib front-end ----------------------------------------------

    def run_ui(self, render_item=None) -> None:  # pragma: no cover - UI
        """Button-grid UI: one button per category + skip/back."""
        import matplotlib.pyplot as plt
        from matplotlib.widgets import Button

        fig = plt.figure(figsize=(10, 6))
        ax_item = fig.add_axes([0.05, 0.35, 0.9, 0.6])

        def draw():
            ax_item.clear()
            ax_item.set_title(
                f"item {self.cursor + 1}/{len(self.items)}"
                + (f" -> {self.assignments.get(self.cursor)}"
                   if self.cursor in self.assignments else ""))
            if render_item and self.current_item is not None:
                render_item(ax_item, self.current_item)
            fig.canvas.draw_idle()
            if self.done:
                plt.close(fig)

        buttons = []
        per_row = 6
        for i, cat in enumerate(self.categories + ["<skip>", "<back>"]):
            r, c = divmod(i, per_row)
            ax = fig.add_axes([0.05 + c * 0.155, 0.25 - r * 0.07,
                               0.145, 0.06])
            btn = Button(ax, cat)

            def make_cb(category=cat):
                def cb(event):
                    if category == "<skip>":
                        self.skip()
                    elif category == "<back>":
                        self.back()
                    else:
                        self.assign(category)
                    draw()
                return cb

            btn.on_clicked(make_cb())
            buttons.append(btn)
        draw()
        plt.show()
