"""Host-side animation of column-model evolution (port of
``climatemodel_tpu/diagnostics/animation.py``).

The reference ``Animate`` class (Model/radiation/animation.py of the NumPy
original): matplotlib FuncAnimation of the
temperature / optical-depth-or-composition / flux profiles, with 1-D (single
latitude, up to 3 panels) and 2-D (latitude x pressure pcolormesh) layouts,
dense-start frame subsampling and automatic truncation once the temperature
stops changing.  Purely host-side: it consumes the snapshot arrays produced by
the device runs (data_dict from evolve_to_equilibrium / save_data).
"""
from __future__ import annotations

import numpy as np

from ..models.column import t_years_days

LW_COLOR = '#ff7f0e'
SW_COLOR = '#1f77b4'
NET_COLOR = '#d62728'
FLUX_PLOT_MAX_AX_LIM = 5.0


class Animate:
    """Animation of T / composition / flux evolution (animation.py:8-359)."""

    def __init__(self, atmos, T_array, t_array, T_eqb=None,
                 correct_solution=True, tau_array=None, flux_array=None,
                 q_array=None, log_axis=True, nPlotFrames=100,
                 fract_frames_at_start=0.25, start_step=3,
                 show_last_frame=False):
        import matplotlib.pyplot as plt
        from matplotlib.animation import FuncAnimation

        self.atmos = atmos
        self.plot_type = 2 if atmos.ny > 1 else 1
        self.T_array = [np.asarray(T) for T in T_array]
        self.t_array = list(t_array)
        self.T_eqb = None if str(atmos) == 'Real Gas' else T_eqb
        self.correct_solution = correct_solution
        self.tau_array = tau_array
        self.flux_array = flux_array
        self.q_array = q_array
        self.log_axis = log_axis
        self.nPlotFrames = nPlotFrames
        self.fract_frames_at_start = fract_frames_at_start
        self.start_step = start_step
        self.show_last_frame = show_last_frame

        self._select_frames()
        self._get_ax_lims()
        self._get_labels()
        if self.T_eqb is None:
            self.T_eqb = self.T_array[-1]

        if self.plot_type == 2:
            self._setup_2d(plt)
            self.anim = FuncAnimation(self.fig, self._frame_2d,
                                      frames=np.size(self.t_plot),
                                      interval=100, blit=False,
                                      repeat_delay=2000)
        else:
            n_plots = 1 + int(self.compos_plot is not None) + \
                int(self.flux_plot is not None)
            if n_plots > 1:
                self.fig, self.axs = plt.subplots(1, n_plots, sharey=True,
                                                  figsize=(6 * n_plots, 5))
                self.ax = self.axs[0]
            else:
                self.fig, self.ax = plt.subplots(1, 1)
                self.axs = None
            self.anim = FuncAnimation(self.fig, self._frame_1d,
                                      frames=np.size(self.t_plot),
                                      interval=100, blit=False,
                                      repeat_delay=2000)

    # ---------------- data selection (animation.py:100-145) ----------------

    def _select_frames(self):
        T_arr = np.asarray(self.T_array)
        F_norm = self.atmos.F_stellar_constant / 4
        if len(self.T_array) > self.nPlotFrames:
            start_end = self.start_step * int(self.fract_frames_at_start
                                              * self.nPlotFrames)
            use_start = np.arange(0, start_end, self.start_step)
            # truncate once the 99th-percentile per-frame change < 0.01 K
            # — percentile over the LEVEL axis only, exactly like the
            # reference (animation.py:113-114): for ny>1 a frame counts as
            # small when ANY latitude's change is small (np.where over the
            # [n_t-1, ny] mask yields duplicated frame indices, preserved)
            small = np.where(np.percentile(np.abs(np.diff(T_arr, axis=0)),
                                           99, axis=1) < 0.01)[0]
            sep = np.where(np.ediff1d(small) > 1)[0]
            if len(sep) == 0:
                max_index = (len(T_arr) - 1 if len(small) == 0
                             else small[0] + 1)
            else:
                max_index = small[max(sep) + 1] + 1
            if self.show_last_frame:
                max_index = len(T_arr) - 1
            use_end = np.linspace(start_end, max_index,
                                  int((1 - self.fract_frames_at_start)
                                      * self.nPlotFrames), dtype=int)
            use = np.unique(np.concatenate((use_start, use_end)))
        else:
            use = np.arange(len(T_arr))
        self.T_plot = T_arr[use]
        self.t_plot = np.asarray(self.t_array)[use]
        self.flux_plot = None
        if self.flux_array is not None and self.plot_type == 1:
            self.flux_plot = {k: np.asarray(v)[use] / F_norm
                              for k, v in self.flux_array.items()}
            self.flux_plot['net'] = (self.flux_plot['lw_up']
                                     + self.flux_plot['sw_up']
                                     - self.flux_plot['lw_down']
                                     - self.flux_plot['sw_down'])
        if self.q_array is not None:
            self.compos_plot = {k: np.asarray(v)[use]
                                for k, v in self.q_array.items()}
        elif self.tau_array is not None:
            tau = {k: np.asarray(v) for k, v in self.tau_array.items()}
            if self.plot_type == 2:
                tau = {k: v[:, :, 0] for k, v in tau.items()}
            self.compos_plot = {'short wave': tau['sw'][use],
                                'long wave': tau['lw'][use]}
        else:
            self.compos_plot = None

    def _get_ax_lims(self):
        self.ax_lims = {}
        T_min = min(T.min() for T in self.T_plot) - 10
        T_max = max(T.max() for T in self.T_plot) + 10
        if self.T_eqb is not None:
            T_min = min(np.min(self.T_eqb) - 10, T_min)
            T_max = max(np.max(self.T_eqb) + 10, T_max)
        self.ax_lims['T'] = (T_min, T_max)
        self.ax_lims['p'] = (self.atmos.p_toa, self.atmos.p_surface)
        if self.compos_plot is not None:
            if self.q_array is None:
                lo = -0.1
            else:
                # positives pooled ACROSS frames per gas (reference
                # animation.py:194-196): an all-zero frame (e.g. a GHG
                # added mid-run) contributes nothing instead of crashing;
                # a gas with no positives anywhere raises like the reference
                lo = min(
                    np.concatenate([np.ravel(v[v > 0]) for v in arr]).min()
                    for arr in self.compos_plot.values())
            hi = max(v.max() for arr in self.compos_plot.values()
                     for v in arr) + 1
            self.ax_lims['compos'] = (lo, hi)
        if self.flux_plot is not None:
            lo = -max(self.flux_plot[k].max() for k in ('lw_down', 'sw_down')) - 0.1
            hi = max(self.flux_plot[k].max() for k in ('lw_up', 'sw_up')) + 0.1
            self.ax_lims['flux'] = [lo, hi]

    def _get_labels(self):
        if self.T_eqb is not None:
            if self.correct_solution and not getattr(self.atmos,
                                                     'sw_tau_is_zero', True):
                eqb, cur = (r'Radiative Equilibrium, $\tau_{sw}\neq 0$',
                            r'Current, $\tau_{sw}\neq0$')
            elif self.correct_solution:
                eqb, cur = (r'Radiative Equilibrium, $\tau_{sw}=0$',
                            r'Current, $\tau_{sw}=0$')
            else:
                eqb, cur = (r'Radiative Equilibrium, $\tau_{sw}=0$ (Wrong)',
                            r'Current, $\tau_{sw}\neq0$')
        else:
            eqb, cur = 'Final', 'Current'
        if self.tau_array is not None:
            cur = 'Current'
        self.labels = {'T_eqb': eqb, 'T_current': cur}

    # ---------------- frames ----------------

    def _frame_1d(self, i):
        ax = self.ax
        ax.clear()
        ax.plot(self.T_plot[0], self.atmos.p, label='Initial', color=SW_COLOR,
                linestyle='dotted')
        ax.plot(self.T_eqb, self.atmos.p, label=self.labels['T_eqb'],
                color=LW_COLOR, linestyle='dotted')
        ax.plot(self.T_plot[i], self.atmos.p, label=self.labels['T_current'],
                color=NET_COLOR)
        ax.set_ylim(self.ax_lims['p'])
        if self.log_axis:
            ax.set_yscale('log')
        ax.invert_yaxis()
        ax.set_xlabel('Temperature / K')
        ax.set_ylabel('Pressure / Pa')
        ax.set_xlim(self.ax_lims['T'])
        ax.legend()
        if self.compos_plot is not None:
            axc = self.axs[1]
            axc.clear()
            for key, arr in self.compos_plot.items():
                axc.plot(arr[0], self.atmos.p, linestyle='dotted')
                axc.plot(arr[i], self.atmos.p, label=key,
                         color=axc.lines[-1].get_color())
            if self.q_array is None:
                axc.set_xlabel(r'$\tau$')
            else:
                axc.set_xlabel('Volume Mixing Ratio (ppmv)')
                axc.set_xscale('log')
            axc.set_xlim(self.ax_lims['compos'])
            if self.log_axis:
                axc.set_yscale('log')
            axc.legend()
        if self.flux_plot is not None:
            axf = self.axs[-1]
            axf.clear()
            sign = {'sw_up': 1.0, 'sw_down': -1.0, 'lw_up': 1.0,
                    'lw_down': -1.0}
            color = {'sw_up': SW_COLOR, 'sw_down': SW_COLOR,
                     'lw_up': LW_COLOR, 'lw_down': LW_COLOR}
            init_label = {'sw_up': '$F_{sw}(t=0)$', 'lw_up': '$F_{lw}(t=0)$',
                          'sw_down': None, 'lw_down': None}
            cur_label = {'sw_up': '$F_{sw}$', 'lw_up': '$F_{lw}$',
                         'sw_down': None, 'lw_down': None}
            for key in sign:
                axf.plot(self.flux_plot[key][0] * sign[key],
                         self.atmos.p_interface, color=color[key],
                         linestyle='dotted', label=init_label[key])
            for key in sign:
                axf.plot(self.flux_plot[key][i] * sign[key],
                         self.atmos.p_interface, color=color[key],
                         label=cur_label[key])
            axf.plot(self.flux_plot['net'][i], self.atmos.p_interface,
                     label='$F_{net}$', color=NET_COLOR)
            axf.set_xlabel(r'Radiation Flux, $F$, as fraction of Incoming '
                           r'Solar, $\frac{F^\odot}{4}$')
            fmax_i = max(self.flux_plot['sw_up'][i].max(),
                         self.flux_plot['lw_up'][i].max())
            fmin_i = -max(self.flux_plot['sw_down'][i].max(),
                          self.flux_plot['lw_down'][i].max())
            hi = (FLUX_PLOT_MAX_AX_LIM
                  if self.ax_lims['flux'][1] > FLUX_PLOT_MAX_AX_LIM > fmax_i
                  else self.ax_lims['flux'][1])
            lo = (-FLUX_PLOT_MAX_AX_LIM
                  if self.ax_lims['flux'][0] < -5
                  and fmin_i > -FLUX_PLOT_MAX_AX_LIM
                  else self.ax_lims['flux'][0])
            axf.set_xlim((lo, hi))
            if self.log_axis:
                axf.set_yscale('log')
            axf.legend()
        t_years, t_days = t_years_days(self.t_plot[i])
        ax.text(0.5, 1.01, f'{t_years:.0f} Years and {t_days:.1f} Days',
                horizontalalignment='center', verticalalignment='bottom',
                transform=ax.transAxes)

    # ---------------- 2-D layout (animation.py:147-177, 313-359) -----------

    def _setup_2d(self, plt):
        from mpl_toolkits.axes_grid1 import make_axes_locatable
        if self.compos_plot is not None:
            fig, axs = plt.subplots(2, 2, figsize=(10, 8),
                                    gridspec_kw={'height_ratios': [3, 1]})
            gs = axs[1, 1].get_gridspec()
            for ax in axs[-1, :]:
                ax.remove()
            self.ax_temp = fig.add_subplot(gs[-1, :])
            self.ax_color = axs[0, 1]
            self.ax_compos = axs[0, 0]
        else:
            fig, (self.ax_color, self.ax_temp) = plt.subplots(
                2, 1, sharex=True, figsize=(6, 8),
                gridspec_kw={'height_ratios': [3, 1]})
            self.ax_compos = None
        self.fig = fig
        div = make_axes_locatable(self.ax_color)
        self.cax = div.append_axes('right', '5%', '5%')
        self.mesh_X, self.mesh_Y = np.meshgrid(self.atmos.latitude,
                                               self.atmos.p[:, 0])

    def _frame_2d(self, i):
        self.cax.cla()
        self.ax_color.clear()
        self.ax_temp.clear()
        im = self.ax_color.pcolormesh(self.mesh_X, self.mesh_Y,
                                      self.T_plot[i], cmap='bwr')
        im.set_clim(self.ax_lims['T'])
        self.ax_color.invert_yaxis()
        self.ax_color.set_ylim(self.ax_lims['p'])
        if self.log_axis:
            self.ax_color.set_yscale('log')
        self.ax_temp.plot(self.atmos.latitude, self.T_plot[0][0],
                          label='initial', linestyle='dotted')
        self.ax_temp.plot(self.atmos.latitude, self.T_plot[i][0],
                          label='current')
        self.ax_temp.set_ylim(self.ax_lims['T'])
        self.ax_temp.set_xlabel('Latitude')
        self.ax_temp.set_ylabel('Surface Temperature / K')
        self.ax_temp.legend(loc='upper right')
        cb = self.fig.colorbar(im, cax=self.cax)
        cb.set_label('Temperature / K')
        if self.ax_compos is not None and self.compos_plot is not None:
            self.ax_compos.clear()
            for key, arr in self.compos_plot.items():
                self.ax_compos.plot(arr[i], self.atmos.p[:, 0], label=key)
            self.ax_compos.set_xlabel(
                r'$\tau$' if self.q_array is None
                else 'Volume Mixing Ratio (ppmv)')
            if self.q_array is not None:
                self.ax_compos.set_xscale('log')
            self.ax_compos.set_xlim(self.ax_lims['compos'])
            if self.log_axis:
                self.ax_compos.set_yscale('log')
            self.ax_compos.invert_yaxis()
            self.ax_compos.legend(loc='upper right')
            self.ax_compos.set_ylabel('Pressure / Pa')
        else:
            self.ax_color.set_ylabel('Pressure / Pa')
        t_years, t_days = t_years_days(self.t_plot[i])
        self.ax_color.text(0.5, 1.01,
                           f'{t_years:.0f} Years and {t_days:.1f} Days',
                           horizontalalignment='center',
                           verticalalignment='bottom',
                           transform=self.ax_color.transAxes)
