"""The port's copy of ``paddle_tpu/plot.py``.

Training-curve plotting (reference: python/paddle/v2/plot/plot.py —
Ploter collecting (step, value) series, matplotlib when available,
DISABLE_PLOT env to run headless)."""

import os

__all__ = ["Ploter", "PlotData"]


class PlotData:
    def __init__(self):
        self.step = []
        self.value = []

    def append(self, step, value):
        self.step.append(step)
        self.value.append(value)

    def reset(self):
        self.step = []
        self.value = []


class Ploter:
    """Collects named cost curves; ``plot()`` renders with matplotlib when
    importable and not disabled, else prints the latest values (headless
    CI behaviour — the reference crashed scripts lacking matplotlib, hence
    its DISABLE_PLOT switch)."""

    def __init__(self, *titles):
        self.__args__ = titles
        self.__plot_data__ = {t: PlotData() for t in titles}
        self._disabled = os.environ.get("DISABLE_PLOT") == "True"
        self._plt = None
        if not self._disabled:
            try:
                import matplotlib
                matplotlib.use("Agg")
                import matplotlib.pyplot as plt
                self._plt = plt
            except Exception:
                self._plt = None

    def append(self, title, step, value):
        self.__plot_data__[title].append(step, value)

    def plot(self, path=None):
        if self._disabled or self._plt is None:
            for t, d in self.__plot_data__.items():
                if d.step:
                    print(f"{t}: step {d.step[-1]} value {d.value[-1]}")
            return
        self._plt.figure()
        for t in self.__args__:
            d = self.__plot_data__[t]
            self._plt.plot(d.step, d.value, label=t)
        self._plt.legend()
        if path:
            self._plt.savefig(path)
        self._plt.close()

    def reset(self):
        for d in self.__plot_data__.values():
            d.reset()
