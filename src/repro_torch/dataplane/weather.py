"""Weather datacube + domain-specific interface (paper §4.2 Meteorology).

Builds the O-grid cube the paper's Table 1 measures against (O1280 ⇒
6 599 680-point fields = "50.4 MB" at float64), synthesises smooth
physical fields, and exposes the domain-level requests: country
extraction, time-series, vertical profiles, flight paths.

:class:`IrregularWeatherCube` is the *Beyond Standard Datacubes*
scenario: merged date/time, mapped Gaussian latitudes, and a cyclic
longitude crossed by the UK polygon — a transformed view over regular
storage, with a :meth:`~IrregularWeatherCube.materialized` oracle for
the differential test harness.

Country boundaries are coarse public-domain polygon approximations —
byte counts depend only on area/geometry, which these preserve.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core import (Box, CyclicTransform, Disk, MappedTransform,
                        MergedTransform, OctahedralGridDatacube, OrderedAxis,
                        Path, Point, Polygon, Request, Select, Span,
                        TensorDatacube, TransformedDatacube)

# (lat, lon) vertex rings — coarse but area-faithful country outlines
COUNTRIES: dict[str, np.ndarray] = {
    "germany": np.array([
        [54.8, 8.6], [54.4, 13.0], [53.5, 14.2], [51.1, 14.9],
        [50.3, 12.2], [48.8, 13.8], [47.5, 13.0], [47.6, 9.6],
        [48.6, 8.0], [49.4, 6.4], [51.0, 6.0], [51.8, 6.1],
        [53.2, 7.2], [53.9, 8.6]], dtype=np.float64),
    "france": np.array([
        [51.0, 2.5], [50.1, 1.6], [49.4, -0.2], [48.6, -1.4],
        [48.6, -4.6], [47.3, -2.5], [46.0, -1.1], [43.4, -1.8],
        [42.7, 3.0], [43.3, 6.6], [44.0, 7.6], [45.9, 6.8],
        [46.4, 6.1], [47.6, 7.6], [49.0, 8.2], [49.8, 4.9]],
        dtype=np.float64),
    "norway": np.array([
        [58.0, 7.0], [58.9, 5.5], [61.0, 4.9], [62.5, 6.0],
        [64.5, 10.5], [67.3, 14.0], [69.5, 18.0], [71.0, 25.8],
        [70.1, 30.8], [69.0, 29.0], [68.4, 22.0], [65.0, 13.5],
        [63.0, 11.5], [60.0, 12.5], [59.0, 11.0]], dtype=np.float64),
    # The UK outline straddles the 0°/360° longitude seam (lon −6.6…1.7):
    # the cross-seam scenario for cyclic-axis extraction (DESIGN.md §2.5).
    "uk": np.array([
        [58.6, -5.0], [57.6, -1.9], [54.6, -0.5], [52.9, 1.7],
        [51.1, 1.4], [50.1, -5.7], [51.6, -4.9], [53.4, -4.6],
        [54.4, -3.2], [55.5, -5.8], [57.0, -6.6]], dtype=np.float64),
    "italy": np.array([
        [46.6, 10.4], [46.4, 13.7], [44.8, 12.4], [43.5, 14.0],
        [41.9, 16.1], [40.0, 18.5], [39.8, 16.6], [38.0, 16.1],
        [38.3, 15.7], [40.0, 15.4], [41.2, 13.0],
        [42.4, 11.0], [43.8, 10.1], [44.4, 8.8], [43.8, 7.5],
        [45.1, 7.1], [45.9, 8.9]], dtype=np.float64),
}


@dataclass
class WeatherCube:
    """time × level × (lat → lon) octahedral datacube."""

    n: int = 32                 # O<n>; Table 1 uses 1280
    n_times: int = 8
    n_levels: int = 20
    dtype: np.dtype = np.dtype(np.float64)

    def __post_init__(self):
        self.time_axis = OrderedAxis("time",
                                     np.arange(self.n_times,
                                               dtype=np.float64) * 3600.0)
        self.level_axis = OrderedAxis("level",
                                      np.arange(self.n_levels,
                                                dtype=np.float64))
        self.cube = OctahedralGridDatacube(
            [self.time_axis, self.level_axis], n=self.n, dtype=self.dtype)

    # -- synthetic physical payload ----------------------------------------
    def field_data(self, seed: int = 0) -> np.ndarray:
        """Smooth (time, level, point) field — low-order harmonics."""
        rng = np.random.default_rng(seed)
        lat_rows = np.repeat(self.cube.latitudes, self.cube.row_counts)
        lon = np.concatenate([
            360.0 * np.arange(c) / c for c in self.cube.row_counts])
        lat_r, lon_r = np.radians(lat_rows), np.radians(lon)
        base = (15.0 * np.cos(lat_r) + 5.0 * np.sin(2 * lon_r) *
                np.cos(lat_r))
        out = np.empty((self.n_times, self.n_levels,
                        self.cube.points_per_field), self.dtype)
        for t in range(self.n_times):
            for l in range(self.n_levels):
                out[t, l] = (base + 0.5 * l + 0.1 * t
                             + rng.normal(0, 0.05))
        return out.reshape(-1)

    # -- domain-specific interface (paper Fig. 5 top level) -------------------
    def country_request(self, name: str, time: float = 0.0,
                        level: float = 0.0) -> Request:
        return Request([Select("time", [time]), Select("level", [level]),
                        Polygon(("lat", "lon"), COUNTRIES[name])])

    def country_box_request(self, name: str, time: float = 0.0,
                            level: float = 0.0) -> Request:
        poly = COUNTRIES[name]
        return Request([Select("time", [time]), Select("level", [level]),
                        Box(("lat", "lon"), poly.min(0), poly.max(0))])

    def timeseries_request(self, lat: float, lon: float,
                           t0: float, t1: float,
                           level: float = 0.0) -> Request:
        # Select on ordered axes snaps to the nearest grid point — the
        # paper's time-series use case ("extract data over particular
        # cities or specific points in space").
        return Request([Span("time", t0, t1), Select("level", [level]),
                        Select("lat", [lat]), Select("lon", [lon])])

    def profile_request(self, lat: float, lon: float,
                        time: float = 0.0) -> Request:
        return Request([Select("time", [time]),
                        Span("level", 0.0, self.n_levels - 1.0),
                        Select("lat", [lat]), Select("lon", [lon])])

    def flight_path_request(self, waypoints: np.ndarray,
                            width: float = 1.0) -> Request:
        """waypoints (K, 4): (time, level, lat, lon) — a swept tube."""
        base = Box(("level", "lat", "lon"),
                   [-0.5, -width / 2, -width / 2],
                   [0.5, width / 2, width / 2])
        return Request([
            Path(("time", "level", "lat", "lon"), base, waypoints)])


def gaussian_latitudes(n: int) -> np.ndarray:
    """``n`` Gaussian-quadrature latitudes, north→south (degrees).

    Legendre nodes cluster toward the poles — genuinely irregular
    spacing, the reduced-grid latitude ladder of production NWP output.
    """
    nodes, _ = np.polynomial.legendre.leggauss(n)
    return np.degrees(np.arcsin(nodes))[::-1].copy()


@dataclass
class IrregularWeatherCube:
    """Production-shaped irregular datacube (*Beyond Standard Datacubes*):

    * **merged** date + time-of-day axes presented as one ``datetime``
      logical axis (seconds);
    * **mapped** Gaussian latitudes — storage holds plain row indices,
      the logical ``lat`` axis carries the irregularly spaced physical
      coordinates;
    * **cyclic** ``lon`` with period 360° — requests (e.g. the UK
      polygon) may straddle the 0°/360° seam.

    Storage is a regular ``TensorDatacube``; all irregularity lives in
    the transform layer, so :meth:`materialized` can build the
    explicitly unrolled/merged/remapped equivalent cube with the *same*
    flat layout — the oracle for the differential test harness
    (tests/test_transforms.py).
    """

    n_dates: int = 2
    times_per_day: int = 4
    n_levels: int = 3
    n_lat: int = 96
    n_lon: int = 192
    dtype: np.dtype = np.dtype(np.float64)

    def __post_init__(self):
        self.date_values = np.arange(self.n_dates) * 86400.0
        self.time_values = np.arange(self.times_per_day) * (
            86400.0 / self.times_per_day)
        self.latitudes = gaussian_latitudes(self.n_lat)
        self.lon_values = 360.0 * np.arange(self.n_lon) / self.n_lon
        base = TensorDatacube([
            OrderedAxis("date", self.date_values),
            OrderedAxis("time", self.time_values),
            OrderedAxis("level", np.arange(float(self.n_levels))),
            OrderedAxis("lat_row", np.arange(float(self.n_lat))),
            OrderedAxis("lon", self.lon_values),
        ], dtype=self.dtype)
        self.transforms = [
            MergedTransform("datetime", ("date", "time")),
            MappedTransform("lat", "lat_row", values=self.latitudes),
            CyclicTransform("lon", period=360.0),
        ]
        self.cube = TransformedDatacube(base, self.transforms)

    @property
    def datetime_values(self) -> np.ndarray:
        return (self.date_values[:, None] +
                self.time_values[None, :]).ravel()

    def materialized(self) -> TensorDatacube:
        """The explicitly merged/remapped cube over plain axes — same
        flat storage layout, so plans against it are the byte-exact
        reference for transformed extraction (cross-seam requests must
        be split manually; see tests/test_transforms.py)."""
        return TensorDatacube([
            OrderedAxis("datetime", self.datetime_values),
            OrderedAxis("level", np.arange(float(self.n_levels))),
            OrderedAxis("lat", self.latitudes),
            OrderedAxis("lon", self.lon_values),
        ], dtype=self.dtype)

    # -- synthetic physical payload ----------------------------------------
    def field_data(self, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        lat_r = np.radians(self.latitudes)
        lon_r = np.radians(self.lon_values)
        grid = (15.0 * np.cos(lat_r)[:, None] +
                5.0 * np.sin(2 * lon_r)[None, :] * np.cos(lat_r)[:, None])
        n_dt = self.n_dates * self.times_per_day
        out = np.empty((n_dt, self.n_levels, self.n_lat, self.n_lon),
                       self.dtype)
        for t in range(n_dt):
            for l in range(self.n_levels):
                out[t, l] = grid + 0.5 * l + 1e-4 * t + rng.normal(0, 0.05)
        return out.reshape(-1)

    # -- domain-specific interface -----------------------------------------
    def country_request(self, name: str, datetime: float = 0.0,
                        level: float = 0.0) -> Request:
        """Country crop; ``uk`` straddles the longitude seam."""
        return Request([Select("datetime", [datetime]),
                        Select("level", [level]),
                        Polygon(("lat", "lon"), COUNTRIES[name])])

    def timeseries_request(self, lat: float, lon: float, t0: float,
                           t1: float, level: float = 0.0) -> Request:
        """Point time-series; a [t0, t1] spanning a date boundary crosses
        the merged date/time storage split transparently."""
        return Request([Span("datetime", t0, t1), Select("level", [level]),
                        Select("lat", [lat]), Select("lon", [lon])])

    def seam_box_request(self, lat_lo: float, lat_hi: float,
                         lon_lo: float, lon_hi: float,
                         datetime: float = 0.0,
                         level: float = 0.0) -> Request:
        """Axis-aligned crop in unwrapped lon coordinates (may straddle
        the seam, e.g. lon −20…20)."""
        return Request([Select("datetime", [datetime]),
                        Select("level", [level]),
                        Box(("lat", "lon"), [lat_lo, lon_lo],
                            [lat_hi, lon_hi])])


# Default spot locations for serving mixes: London, Paris, New York,
# Tokyo (lat, lon).
SPOT_LOCATIONS = ((51.5, 0.0), (48.9, 2.3), (40.7, -74.0), (35.7, 139.7))


def request_population(wc: WeatherCube,
                       spots=SPOT_LOCATIONS) -> list[Request]:
    """Ranked serving-mix population: country crops × time/level, spot
    time-series, vertical profiles.  Zipf-sampling over this list makes
    a few crops hot — the repetitive production stream the plan cache
    (DESIGN.md §4) targets; used by ``launch/serve.py --mode extract``
    and ``benchmarks/bench_plan_cache.py``."""
    population = []
    for name in COUNTRIES:
        for t in (0.0, 3600.0):
            for lev in (0.0, 1.0):
                population.append(wc.country_request(name, t, lev))
    for lat, lon in spots:
        population.append(wc.timeseries_request(lat, lon, 0.0,
                                                3 * 3600.0))
        population.append(wc.profile_request(lat, lon))
    return population


def paris_newyork_path(cube: WeatherCube, n_wp: int = 8) -> np.ndarray:
    """Great-circle-ish Paris→New York descent/climb profile."""
    lats = np.linspace(48.85, 40.7, n_wp)
    lons = np.linspace(2.35, -74.0, n_wp)
    levels = np.concatenate([
        np.linspace(0, cube.n_levels - 1, n_wp // 2),
        np.linspace(cube.n_levels - 1, 0, n_wp - n_wp // 2)])
    times = np.linspace(0, (cube.n_times - 1) * 3600.0, n_wp)
    return np.stack([times, levels, lats, lons], axis=1)
