"""Physical constants of the PyTorch port.

The same values as ``climatemodel_tpu/constants.py`` (``sympl``'s default
constant registry, inlined), so both packages march the same physics.
"""

# --- sympl default constants (Model/constants.py:3-16) ---
g = 9.80665                      # gravitational acceleration (m s^-2)
c_p_dry = 1004.64                # heat capacity of dry air at constant p (J kg^-1 K^-1)
sigma = 5.670367e-8              # Stefan-Boltzmann constant (W m^-2 K^-4)
p_surface_earth = 1.0132e5       # reference air pressure (Pa)
F_sun = 1367.0                   # solar constant (W m^-2)
Omega = 7.292e-5                 # planetary rotation rate (s^-1)
R_earth = 6.371e6                # planetary radius (m)
R_specific = 287.0               # gas constant of dry air (J kg^-1 K^-1)
Avogadro = 6.022140857e23        # Avogadro constant (mole^-1)
speed_of_light = 299792458.0     # speed of light (m s^-1)
h_planck = 6.62607004e-34        # Planck constant (J s)
k_boltzmann = 1.38064852e-23     # Boltzmann constant (J K^-1)

# --- literal constants (Model/constants.py:7-8,17-19) ---
p_one_atmosphere = 101325.0      # one atmosphere (Pa)
p_toa_earth = 20.0               # default top-of-atmosphere pressure (Pa)
AU = 1.495978707e11              # mean earth-sun distance (m)
R_sun = 6.96340e8                # radius of sun (m)
T_sun = 5778.0                   # effective temperature of sun (K)

SECONDS_PER_DAY = 24 * 60 ** 2
SECONDS_PER_YEAR = 365 * SECONDS_PER_DAY
